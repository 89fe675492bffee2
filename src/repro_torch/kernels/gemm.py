"""K1: the CUDA GEMM — the "library call" target of the BLAS-3 idiom.

Port of ``repro/kernels/gemm.py::gemm`` (the Pallas TPU GEMM).  The kernels
are in ``repro_torch/csrc/gemm.cu``: float32 runs on the tensor cores
(``mma.sync`` TF32) with error-compensated TF32, three passes over a big/small
split of each operand into one fp32 accumulator, so the product stays within
the reference's 2e-4; bfloat16 runs a tiled SIMT kernel with an fp32
accumulator.  The output is in the input dtype.  The block shapes are the
kernels' own (128x64 tiles in float32), so ``gemm`` takes no tile argument:
the reference's ``block_m/n/k`` sized TPU VMEM blocks.

``gemm`` launches a kernel for CUDA tensors and takes ``gemm_plain``
(``kernels.ref.matmul``), the same product in torch with an fp32
accumulator, for CPU tensors only.
``LAUNCHES`` counts kernel launches and ``PLAIN`` the plain-version runs.
``launch_f32`` is the float32 launch itself, which K6's float32 path shares
with the expert as the batch axis.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import cuda_library
from .ref import matmul as gemm_plain
from .runtime import arrival_counters, on_device, raw_stream, sm_count

LAUNCHES = {"gemm": 0}
PLAIN = {"gemm": 0}

# the float32 kernel's block tile and K slice (csrc/gemm.cu)
TILE_M, TILE_N, SLICE_K = 128, 64, 32
MAX_SPLITS = 4
MIN_SLICES = 4  # K slices in each range of a split
# What a range's fp32 partial tile costs (it goes to memory and back once), in
# K of one tile's work.  chip_smoke.py times each main-path product that
# splits beside the same product unsplit.
PARTIAL_K = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"repro_gemm_f32": [_P] * 3 + [_I] * 4 + [_P] * 3,  # m, n, k, splits, ws, cnt
             "repro_gemm_batched_f32": [_P] * 3 + [_I] * 5 + [_P] * 3,  # batch first
             "repro_gemm_bf16": [_P] * 3 + [_I] * 3 + [_P]}  # x, y, out, m, n, k, stream


@functools.cache
def gemm_splits(batch: int, m: int, n: int, k: int, sms: int) -> int:
    """How many contiguous K ranges the float32 kernel splits a product into
    on a card of ``sms`` SMs: the S in 1..4 (each range at least 4 slices of
    32) that least loads the busiest SM, ``ceil(tiles * S / sms) / S`` tiles'
    work, plus ``(S - 1) * PARTIAL_K / k`` for the partials' round trip; the
    smaller S on a tie.  Pure, decided before launch."""
    tiles = batch * math.ceil(m / TILE_M) * math.ceil(n / TILE_N)
    top = min(MAX_SPLITS, math.ceil(k / SLICE_K) // MIN_SLICES)
    if top <= 1:
        return 1
    cost = {s: math.ceil(tiles * s / sms) / s + (s - 1) * PARTIAL_K / k for s in range(1, top + 1)}
    return min(cost, key=lambda s: (cost[s], s))


@functools.cache
def _entry(name: str):
    fn = getattr(cuda_library("gemm"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def launch_f32(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, batch: int, m: int, n: int,
               k: int, *, splits: int | None = None) -> None:
    """Launch the float32 kernel on contiguous tensors of the current CUDA
    device, x (batch, m, k) and y (batch, k, n) into out (batch, m, n), on its
    current stream, splitting K into ``splits`` ranges (None: ``gemm_splits``'
    pick); raises on a launch error.  Counts nothing: the caller does."""
    dev = x.device
    stream = raw_stream(dev)
    if splits is None:
        splits = gemm_splits(batch, m, n, k, sm_count(dev))
    ws = cnt = None  # held until the launch is queued
    if splits > 1:
        tiles = batch * math.ceil(m / TILE_M) * math.ceil(n / TILE_N)
        ws = torch.empty(splits * batch * m * n, dtype=torch.float32, device=dev)
        cnt = arrival_counters(dev, tiles)  # one per output tile
    extra = (splits, ws.data_ptr() if ws is not None else None,
             cnt.data_ptr() if cnt is not None else None, stream)
    if batch == 1:
        err = _entry("repro_gemm_f32")(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, *extra)
    else:
        err = _entry("repro_gemm_batched_f32")(x.data_ptr(), y.data_ptr(), out.data_ptr(), batch,
                                               m, n, k, *extra)
    if err != 0:
        raise RuntimeError(f"gemm float32 kernel launch failed with CUDA error {err}")


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for row-major 2-D float32/bfloat16 tensors on one device."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.bfloat16):
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
    with on_device(x.device):
        if x.dtype == torch.float32:
            launch_f32(x, y, out, 1, m, n, k)
        else:
            err = _entry("repro_gemm_bf16")(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                                            raw_stream(x.device))
            if err != 0:
                raise RuntimeError(f"gemm bfloat16 kernel launch failed with CUDA error {err}")
    LAUNCHES["gemm"] += 1
    return out
