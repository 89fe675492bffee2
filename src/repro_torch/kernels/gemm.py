"""K1: the CUDA GEMM — the "library call" target of the BLAS-3 idiom.

Port of ``repro/kernels/gemm.py::gemm`` (the Pallas TPU GEMM).  The kernel is
``repro_torch/csrc/gemm.cu``: a tiled SIMT GEMM with an fp32 accumulator that
writes the input dtype (float32 or bfloat16).  Its block shape is its own
(64x64 output tiles), so it takes no tile argument: the reference's
``block_m/n/k`` sized TPU VMEM blocks.

``gemm`` launches the kernel for CUDA tensors and takes ``gemm_plain``, the
same product in torch with an fp32 accumulator, for CPU tensors only.
``LAUNCHES`` counts kernel launches and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import ctypes

import torch

from .build import cuda_library

LAUNCHES = {"gemm": 0}
PLAIN = {"gemm": 0}

_DTYPES = {torch.float32: "repro_gemm_f32", torch.bfloat16: "repro_gemm_bf16"}


def gemm_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in torch with an fp32 accumulator, returned in ``x.dtype``."""
    return (x.to(torch.float32) @ y.to(torch.float32)).to(x.dtype)


def _entry(dtype: torch.dtype):
    fn = getattr(cuda_library("gemm"), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for row-major 2-D float32/bfloat16 tensors on one device."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"gemm: dtypes {x.dtype}, {y.dtype} (want one of float32, bfloat16)")
    if x.device != y.device:
        raise ValueError(f"gemm: operands on {x.device} and {y.device}")
    if x.device.type == "cpu":
        PLAIN["gemm"] += 1
        return gemm_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gemm: operands must be contiguous (row-major)")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"gemm kernel launch failed with CUDA error {err}")
    LAUNCHES["gemm"] += 1
    return out
