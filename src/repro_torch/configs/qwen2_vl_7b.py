"""qwen2-vl-7b — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only: the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings (B, S, D) plus 3-axis M-RoPE position ids.
Dynamic resolution = variable patches per image, which the segmented
(JugglePAC) pooling path handles; decode uses text tokens."""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    period=(BlockSpec("attn", "swiglu"),),
    mrope=True,
    rope_theta=1e6,
    embed_inputs=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=256, vocab=512, dtype="float32")
