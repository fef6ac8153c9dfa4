"""seamless-m4t-large-v2 — enc-dec, 24L encoder + 24L decoder, d_model=1024
16H (MHA kv=16) d_ff=8192 vocab=256206, multimodal. [arXiv:2308.11596; hf]

Backbone only: the speech frontend is a STUB — input_specs() provides
precomputed audio-frame embeddings (B, S_enc, D) for the encoder; the
decoder consumes text tokens with cross-attention to the encoder memory."""

from repro_torch.models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    period=(BlockSpec("attn", "gelu"),),
    encoder_layers=24,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                      d_ff=256, vocab=512, encoder_layers=2, dtype="float32")
