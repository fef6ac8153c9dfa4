"""deepseek-7b — 30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400,
llama architecture. [arXiv:2401.02954; hf]"""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    period=(BlockSpec("attn", "swiglu"),),
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512, dtype="float32")
