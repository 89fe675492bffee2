"""K4: the CUDA RMSNorm of the model stack.

Port of ``repro/kernels/rmsnorm.py::rmsnorm`` (the Pallas TPU kernel).  The
kernel is ``repro_torch/csrc/rmsnorm.cu``: one block per row, the row and
gamma held in registers from 16-byte loads at the model widths (read once),
a fixed-order block reduction, fp32 math, gamma (in ``x``'s type) applied in
fp32, the output in ``x``'s type (float32 or bfloat16); other widths and
unaligned tensors take a looping kernel.

``rmsnorm_bwd`` is K4-bwd, its gradient (no TPU kernel: the reference
differentiates its plain version with XLA; the card needs a kernel for
``loss.backward()``).  It recomputes each row's ``r = rsqrt(mean(x^2) + eps)``
and writes ``dx = r (gamma dy) - x r^3 mean(x gamma dy)``; ``dgamma``, the sum
over rows of ``dy x r``, goes through per-block fp32 partials that a second
kernel adds in block order, so it is bit-identical run to run (no float
atomics).  ``BWD_BLOCKS_PER_SM`` blocks an SM walk the rows.

``rmsnorm`` and ``rmsnorm_bwd`` launch their kernels for CUDA tensors and
take ``kernels.ref.rmsnorm`` / ``kernels.ref.rmsnorm_grad`` for CPU tensors
only.  ``LAUNCHES`` counts kernel launches and ``PLAIN`` the plain-version
runs, per function.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library
from .runtime import on_device, raw_stream, sm_count

LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0}
PLAIN = {"rmsnorm": 0, "rmsnorm_bwd": 0}
BWD_BLOCKS_PER_SM = 4  # csrc/rmsnorm.cu: K4-bwd's grid, in blocks an SM
BWD_MAX_D = 8192       # and its widest row (8 values a thread, 1024 threads)

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(cuda_library("rmsnorm"), f"repro_rmsnorm_{_NAMES[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry(dtype: torch.dtype):
    fn = getattr(cuda_library("rmsnorm"), f"repro_rmsnorm_bwd_{_NAMES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, gamma: torch.Tensor) -> None:
    d = x.shape[-1]
    if gamma.shape != (d,):
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} for rows of {d}")
    if x.dtype not in _NAMES or gamma.dtype != x.dtype:
        raise TypeError(f"{name}: dtypes {x.dtype}, {gamma.dtype} "
                        "(want both float32 or both bfloat16)")
    if x.device != gamma.device:
        raise ValueError(f"{name}: x on {x.device}, gamma on {gamma.device}")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * gamma`` over the last axis of ``x``
    (any leading shape); ``gamma`` has ``x.shape[-1]`` entries of ``x``'s type."""
    _check("rmsnorm", x, gamma)
    d = x.shape[-1]
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
    with on_device(x.device):
        err = _entry(x.dtype)(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
                              float(eps), raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dx, dgamma)`` of ``rmsnorm(x, gamma)`` for the output
    gradient ``dy`` (``x``'s shape and type): ``dx`` in ``x``'s type,
    ``dgamma`` in ``gamma``'s."""
    _check("rmsnorm_bwd", x, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} for x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type == "cpu":
        PLAIN["rmsnorm_bwd"] += 1
        return ref.rmsnorm_grad(x, gamma, dy, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    d = x.shape[-1]
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {d} > {BWD_MAX_D}")
    x, gamma, dy = x.contiguous(), gamma.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return dx, torch.zeros_like(gamma)
    dgamma = torch.empty_like(gamma)
    blocks = min(rows, BWD_BLOCKS_PER_SM * sm_count(x.device))
    part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        err = _bwd_entry(x.dtype)(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                  dgamma.data_ptr(), part.data_ptr(), rows, d, blocks,
                                  float(eps), raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed with CUDA error {err}")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dgamma
