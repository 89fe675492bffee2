"""Qwen3-MoE 235B-A22B [hf:Qwen]: 128-expert top-8, GQA kv=4, d_ff/expert 1536."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, moe_period=1,
    rope_theta=1e6,
)
