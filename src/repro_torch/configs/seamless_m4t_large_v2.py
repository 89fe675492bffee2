"""SeamlessM4T-Large v2 [arXiv:2308.11596]: encoder-decoder, audio frontend STUB.

input_specs() supplies precomputed speech frame embeddings to the encoder;
the text decoder (24L) performs self- + cross-attention over encoder memory.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_layers=24, rope_theta=1e4,
    frontend="audio", frontend_len=4096,
)
