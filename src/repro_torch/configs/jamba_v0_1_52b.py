"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
Mamba + attention 1:7 interleave, MoE 16 experts top-2 every other layer.
[arXiv:2403.19887; hf]

Period of 8 (the Jamba block): attention at position 4, Mamba elsewhere;
MoE MLP at odd positions, dense SwiGLU at even ones."""

from repro_torch.models.config import BlockSpec, MambaCfg, ModelConfig, MoECfg

_PERIOD = tuple(
    BlockSpec("attn" if i == 4 else "mamba",
              "moe" if i % 2 == 1 else "swiglu")
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    period=_PERIOD,
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    subquadratic=True,        # hybrid: O(1) mamba state + 4 attn layers
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=256),
    mamba=MambaCfg(d_state=4, d_conv=4, expand=2), dtype="float32")
