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
over rows of ``dy x r``, goes through per-block fp32 partial rows that a
second kernel adds across the card (a block per 32 columns), each sum in a
fixed order, so both are bit-identical run to run (no float atomics).
``bwd_plan`` decides the route before launch: at the model widths (D a
multiple of the 16-byte chunk, aligned tensors) ``rmsnorm_bwd_vec_kernel``,
rows held in registers from 16-byte loads by groups of warps, the next row
in flight, one block an SM; otherwise ``rmsnorm_bwd_kernel``, element by
element, ``BWD_BLOCKS_PER_SM`` blocks an SM.

``rmsnorm`` and ``rmsnorm_bwd`` launch their kernels for CUDA tensors and
take ``kernels.ref.rmsnorm`` / ``kernels.ref.rmsnorm_grad`` for CPU tensors
only.  ``LAUNCHES`` counts kernel launches and ``PLAIN`` the plain-version
runs, per function; ``BWD_PATHS`` counts K4-bwd's calls by route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import ref
from .build import cuda_library
from .runtime import on_device, raw_stream, sm_count

LAUNCHES = {"rmsnorm": 0, "rmsnorm_bwd": 0}
BWD_PATHS = {"vec": 0, "loop": 0}
PLAIN = {"rmsnorm": 0, "rmsnorm_bwd": 0}
BWD_MAX_D = 8192       # K4-bwd's widest row (the loop kernel: 8 values a thread, 1024 threads)
BWD_BLOCKS_PER_SM = 4  # csrc/rmsnorm.cu: the loop kernel's grid, in blocks an SM
BWD_BLOCK = 512        # and the vector kernel's threads a block: row groups (slots)
BWD_CHUNKS = 4         # its 16-byte chunks of a row a thread, at most


class BwdPlan(NamedTuple):
    """K4-bwd's launch: ``route`` ``"vec"`` or ``"loop"``; ``group``, the
    vector kernel's threads a row (0 for the loop kernel); ``chunks``, its
    16-byte chunks a thread (0 for the loop kernel); ``slots``, its row
    groups a block (1 for the loop kernel); ``blocks``, the grid, which is
    also the number of fp32 partial dgamma rows."""

    route: str
    group: int
    chunks: int
    slots: int
    blocks: int


def bwd_plan(dtype: torch.dtype, rows: int, d: int, aligned: bool, sms: int) -> BwdPlan:
    """K4-bwd's launch for ``rows`` x ``d`` of ``dtype`` on a card of ``sms``
    SMs; ``aligned``: x, gamma, dy and dx start on 16 bytes.  ``d`` a
    multiple of the 16-byte chunk and aligned tensors take the vector
    kernel: warps a row the fewest that hold at most ``BWD_CHUNKS`` chunks a
    thread, ``BWD_BLOCK // group`` rows at a time a block, one block an SM at
    most, so at most ``sms`` partial rows.  Everything else takes the loop
    kernel, ``BWD_BLOCKS_PER_SM`` blocks an SM.  Pure, decided before
    launch."""
    per_chunk = 16 // dtype.itemsize
    if aligned and d > 0 and d % per_chunk == 0:
        n = d // per_chunk
        group = 32 * math.ceil(n / (32 * BWD_CHUNKS))
        if group <= BWD_BLOCK:
            slots = BWD_BLOCK // group
            return BwdPlan("vec", group, math.ceil(n / group), slots,
                           min(math.ceil(rows / slots), sms))
    return BwdPlan("loop", 0, 0, 1, min(rows, BWD_BLOCKS_PER_SM * sms))

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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, gamma, dy, dx))
    plan = bwd_plan(x.dtype, rows, d, aligned, sm_count(x.device))
    part = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    with on_device(x.device):
        err = _bwd_entry(x.dtype)(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                  dgamma.data_ptr(), part.data_ptr(), rows, d, plan.blocks,
                                  plan.group, float(eps), raw_stream(x.device))
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed with CUDA error {err}")
    LAUNCHES["rmsnorm_bwd"] += 1
    BWD_PATHS[plan.route] += 1
    return dx, dgamma
