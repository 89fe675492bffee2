"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower is a STUB per the assignment: input_specs() supplies
precomputed anyres patch embeddings (frontend_len tokens of d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    rope_theta=1e6,
    frontend="vision", frontend_len=2880,  # anyres: 5 tiles x 576 patches
)
