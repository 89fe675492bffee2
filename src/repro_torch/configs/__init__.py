"""Architecture registry: ``--arch <id>`` resolves here.

A copy of ``repro/configs`` (this package and its ten config files), so the
port and the reference build their models from the same numbers.
"""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401

from .mixtral_8x7b import CONFIG as _mixtral
from .qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from .minicpm_2b import CONFIG as _minicpm
from .h2o_danube_3_4b import CONFIG as _danube
from .qwen1_5_32b import CONFIG as _qwen15
from .mistral_large_123b import CONFIG as _mistral_large
from .llava_next_mistral_7b import CONFIG as _llava
from .seamless_m4t_large_v2 import CONFIG as _seamless
from .jamba_1_5_large_398b import CONFIG as _jamba
from .xlstm_350m import CONFIG as _xlstm

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _mixtral, _qwen3moe, _minicpm, _danube, _qwen15,
        _mistral_large, _llava, _seamless, _jamba, _xlstm,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
