"""deepseek-v2-lite-16b — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512, MoE 64 routed top-6 + 2 shared. [arXiv:2405.04434; hf]

Assignment note: the spec line says both "MoE 64e top-6" and "160 routed";
64 routed experts is the published V2-Lite config, so we use 64 (160 is the
full V2).  All 27 layers are MoE per the assignment line (the HF checkpoint
makes layer 0 dense; the assignment config omits that, and we follow the
assignment — recorded in DESIGN.md §Arch-applicability)."""

from repro_torch.models.config import BlockSpec, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    period=(BlockSpec("attn", "moe"),),
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
               d_ff_shared=1408, router_norm_topk=True),
    attn_type="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, d_ff=64, vocab=512,
    moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=64, num_shared=1,
               d_ff_shared=64, router_norm_topk=True),
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    dtype="float32")
