"""Jamba-1.5-Large [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2.

Layer layout: one attention layer per 8 (attn_period=8), the rest Mamba;
every second layer's FFN is MoE (moe_period=2, offset 1).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_period=2, moe_offset=1,
    attn_period=8, attn_offset=0,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_theta=1e6,
)
