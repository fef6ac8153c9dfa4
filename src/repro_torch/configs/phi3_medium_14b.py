"""phi3-medium-14b — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE + SwiGLU + GQA. [arXiv:2404.14219]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    period=(BlockSpec("attn", "swiglu"),),
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab=512, dtype="float32")
