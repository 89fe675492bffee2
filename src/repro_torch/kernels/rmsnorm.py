"""K4: the CUDA RMSNorm of the model stack.

Port of ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas TPU kernel).  The
kernel is ``repro_torch/csrc/rmsnorm.cu``: one warp per row, fp32 math, gamma
(in ``x``'s type) applied in fp32, the output in ``x``'s type (float32 or
bfloat16).

``rmsnorm`` launches the kernel for CUDA tensors and takes
``kernels.ref.rmsnorm`` for CPU tensors only.  ``LAUNCHES`` counts kernel
launches and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library

LAUNCHES = {"rmsnorm": 0}
PLAIN = {"rmsnorm": 0}

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(cuda_library("rmsnorm"), f"repro_rmsnorm_{_NAMES[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * gamma`` over the last axis of ``x``
    (any leading shape); ``gamma`` has ``x.shape[-1]`` entries of ``x``'s type."""
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"rmsnorm: gamma {tuple(gamma.shape)} for rows of {d}")
    if x.dtype not in _NAMES or gamma.dtype != x.dtype:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {gamma.dtype} "
                        "(want both float32 or both bfloat16)")
    if x.device != gamma.device:
        raise ValueError(f"rmsnorm: x on {x.device}, gamma on {gamma.device}")
    if x.device.type == "cpu":
        PLAIN["rmsnorm"] += 1
        return ref.rmsnorm(x, gamma, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out
