"""xlstm-125m — 12L d_model=768 4 heads vocab=50304, sLSTM + mLSTM blocks,
no separate FFN (d_ff=0). [arXiv:2405.04517]

Block mix: 3 mLSTM : 1 sLSTM per period (the xLSTM paper's LM configs are
mLSTM-dominant); 12 layers = 3 periods."""

from repro_torch.models.config import BlockSpec, ModelConfig, XLSTMCfg

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    period=(BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"),
            BlockSpec("mlstm", "none"), BlockSpec("slstm", "none")),
    xlstm=XLSTMCfg(num_heads=4, proj_factor_m=2.0, proj_factor_s=4 / 3,
                   conv_kernel=4),
    tie_embeddings=True,
    subquadratic=True,        # O(1) recurrent state
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, vocab=256,
    xlstm=XLSTMCfg(num_heads=2, proj_factor_m=2.0, proj_factor_s=4 / 3,
                   conv_kernel=4),
    dtype="float32")
