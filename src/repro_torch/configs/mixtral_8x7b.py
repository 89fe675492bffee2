"""Mixtral 8x7B [arXiv:2401.04088]: 8-expert top-2 MoE, GQA kv=8, SWA 4096."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, moe_period=1,
    window=4096, rope_theta=1e6,
)
