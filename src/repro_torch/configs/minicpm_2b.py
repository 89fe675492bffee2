"""MiniCPM-2B [arXiv:2404.06395]: llama-like dense, MHA, WSD LR schedule."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753,
    rope_theta=1e4, tie_embeddings=True,
)

# WSD (warmup-stable-decay) is this arch's assigned LR schedule
LR_SCHEDULE = "wsd"
