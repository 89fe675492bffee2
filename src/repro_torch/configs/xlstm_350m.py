"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks (7:1 pattern), no FFN."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
)
