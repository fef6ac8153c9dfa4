"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""

from repro_torch.models.config import BlockSpec, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    period=(BlockSpec("attn", "moe"),),
    moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=16384),
    window=4096,
    rope_theta=1e6,
    subquadratic=True,        # SWA ring cache => O(window) decode memory
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=256), window=16,
    dtype="float32")
