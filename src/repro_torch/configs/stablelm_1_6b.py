"""stablelm-1.6b — 24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    period=(BlockSpec("attn", "swiglu"),),
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512, dtype="float32")
