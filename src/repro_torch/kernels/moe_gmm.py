"""K6: the CUDA grouped matmul of the MoE layer's experts.

Port of ``repro/kernels/moe_gmm.py::grouped_matmul`` (the Pallas TPU kernel).
The kernel is ``repro_torch/csrc/moe_gmm.cu``: ``out[e] = x[e] @ w[e]`` for
x ``(E, C, D)`` and w ``(E, D, F)``, an fp32 accumulator over D, the output in
x's type.  bfloat16 runs on the tensor cores (``mma.sync`` m16n8k16); float32
launches K1's SIMT kernel (``csrc/gemm.cu``) with the expert as its batch
axis.  Ragged C, D and F are masked inside the kernels, so no padded copy is
made (the reference pads to its block sizes).

``grouped_matmul`` launches the kernel for CUDA tensors and takes
``kernels.ref.grouped_matmul`` for CPU tensors only.  ``LAUNCHES`` counts
kernel launches and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library

LAUNCHES = {"grouped_matmul": 0}
PLAIN = {"grouped_matmul": 0}

# dtype -> (library, entry point, int arguments)
_ENTRIES = {torch.bfloat16: ("moe_gmm", "repro_moe_gmm_bf16", 5),   # e, c, d, f, vec
            torch.float32: ("gemm", "repro_gemm_batched_f32", 4)}  # batch, m, n, k


@functools.cache
def _entry(dtype: torch.dtype):
    lib, name, ints = _ENTRIES[dtype]
    fn = getattr(cuda_library(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) per expert -> (E, C, F) in x's type."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _ENTRIES:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype} "
                        "(want both float32 or both bfloat16)")
    if x.device != w.device:
        raise ValueError(f"grouped_matmul: x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        PLAIN["grouped_matmul"] += 1
        return ref.grouped_matmul(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            vec = int(d % 8 == 0 and f % 8 == 0 and x.data_ptr() % 16 == 0
                      and w.data_ptr() % 16 == 0)
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, vec, stream)
        else:
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, f, d, stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed with CUDA error {err}")
    LAUNCHES["grouped_matmul"] += 1
    return out
