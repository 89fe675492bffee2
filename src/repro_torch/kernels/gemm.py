"""K1: the CUDA GEMM — the "library call" target of the BLAS-3 idiom.

Port of ``repro/kernels/gemm.py::gemm`` (the Pallas TPU GEMM): ``x @ y`` for
row-major x (M, K) and y (K, N), an fp32 accumulator, the output in the input
dtype.  Four kernels compute it; ``choose_kernel`` picks one from the dtype,
M, N, K and the operands' 16-byte alignment alone, before any launch:

* ``"tf32x3"`` — ``gemm_tf32x3_kernel`` in ``repro_torch/csrc/gemm.cu``,
  float32 on the tensor cores (``mma.sync`` TF32) with error-compensated
  TF32: three passes over a big/small split of each operand into one fp32
  accumulator, so the product stays within the reference's 2e-4; K split
  into ranges by ``gemm_splits``;
* ``"wgmma"`` — ``moe_gmm_wgmma_kernel`` in ``repro_torch/csrc/moe_gmm.cu``,
  bf16 with M >= 32, K and N multiples of 8 and aligned operands: K6's
  prefill pipeline (``wgmma`` fed by TMA, 128 x 256 tiles) at E = 1, its
  tiles in K6's order (every M tile of one N tile, then the next);
* ``"decode"`` — ``moe_gmm_decode_kernel`` in the same file, the same bf16
  shapes with M < 32: K6's decode kernel at E = 1, y streamed by TMA;
* ``"mma"`` — ``moe_gmm_bf16_kernel`` in the same file, any other bf16 shape
  (K or N not a multiple of 8, K = 0, an unaligned operand): K6's
  ``mma.sync`` kernel at E = 1, which masks any shape.

A dense product is a grouped product with one expert, so the bf16 products
launch K6's entry points with E = 1, C = M, D = K and F = N; they are counted
here (``PATHS``), never in K6's ``PATHS``.  A profile sees K6's kernel names.
The tiling is the kernels' own, so ``gemm`` takes no tile argument: the
reference's ``block_m/n/k`` sized TPU VMEM blocks.

``gemm`` launches a kernel for CUDA tensors and takes ``gemm_plain``
(``kernels.ref.matmul``), the same product in torch with an fp32
accumulator, for CPU tensors only.
``LAUNCHES`` counts kernel launches, ``PATHS`` the launches of each kernel
and ``PLAIN`` the plain-version runs.  ``launch_f32`` is the float32 launch
itself, which K6's float32 path shares with the expert as the batch axis.
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
PATHS = {"tf32x3": 0, "wgmma": 0, "decode": 0, "mma": 0}
PLAIN = {"gemm": 0}

# the float32 kernel's block tile and K slice (csrc/gemm.cu)
TILE_M, TILE_N, SLICE_K = 128, 64, 32
MAX_SPLITS = 4
MIN_SLICES = 4  # K slices in each range of a split
# What a range's fp32 partial tile costs (it goes to memory and back once), in
# K of one tile's work.  chip_smoke.py times each main-path product that
# splits beside the same product unsplit.
PARTIAL_K = 64

# bf16: the wgmma kernel takes M from here up and the decode kernel below it,
# the line K6 draws between the same two kernels (moe_gmm.WGMMA_MIN_C)
WGMMA_MIN_M = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> (library, argument types)
_ARGTYPES = {"repro_gemm_f32": ("gemm", [_P] * 3 + [_I] * 4 + [_P] * 3),  # m, n, k, splits, ws, cnt
             "repro_gemm_batched_f32": ("gemm", [_P] * 3 + [_I] * 5 + [_P] * 3),  # batch first
             # K6's: x, w, out, e, c, d, f[, vec], stream
             "repro_moe_gmm_wgmma_bf16": ("moe_gmm", [_P] * 3 + [_I] * 4 + [_P]),
             "repro_moe_gmm_decode_bf16": ("moe_gmm", [_P] * 3 + [_I] * 4 + [_P]),
             "repro_moe_gmm_bf16": ("moe_gmm", [_P] * 3 + [_I] * 5 + [_P])}
_DTYPES = {"tf32x3": torch.float32, "wgmma": torch.bfloat16, "decode": torch.bfloat16,
           "mma": torch.bfloat16}
# each kernel's name on the card, as a profile shows it
KERNELS = {"tf32x3": "gemm_tf32x3_kernel", "wgmma": "moe_gmm_wgmma_kernel",
           "decode": "moe_gmm_decode_kernel", "mma": "moe_gmm_bf16_kernel"}


def choose_kernel(dtype: torch.dtype, m: int, n: int, k: int, aligned: bool) -> str:
    """``"tf32x3"``, ``"wgmma"``, ``"decode"`` or ``"mma"`` for ``x (m, k) @
    y (k, n)`` of this dtype; ``aligned``: x and y start on 16 bytes.

    float32 takes ``"tf32x3"``.  bf16 with ``K > 0``, ``K % 8 == 0``, ``N %
    8 == 0`` and both operands aligned (TMA's 16-byte row strides and
    addresses) takes the wgmma kernel from ``M = WGMMA_MIN_M`` up and the
    decode kernel below it; every other bf16 shape takes the ``mma.sync``
    kernel.  Pure, decided before launch."""
    if dtype == torch.float32:
        return "tf32x3"
    if not (k > 0 and k % 8 == 0 and n % 8 == 0 and aligned):
        return "mma"
    return "wgmma" if m >= WGMMA_MIN_M else "decode"


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
    lib, argtypes = _ARGTYPES[name]
    fn = getattr(cuda_library(lib), name)
    fn.argtypes = argtypes
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
    _check(x, y)
    if x.device.type == "cpu":
        PLAIN["gemm"] += 1
        return gemm_plain(x, y)
    return _launch(None, x, y)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm: dtypes {x.dtype}, {y.dtype} (want one of float32, bfloat16)")
    if x.device != y.device:
        raise ValueError(f"gemm: operands on {x.device} and {y.device}")


def _launch(kernel: str | None, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the named kernel (``"tf32x3"``, ``"wgmma"``, ``"decode"`` or
    ``"mma"``; ``None``: ``choose_kernel``'s pick) on CUDA tensors, or raise
    if it does not take them.  ``gemm`` goes through here with ``None``; the
    card tests name a kernel to hold each against the plain version."""
    if kernel is not None and kernel not in _DTYPES:
        raise ValueError(f"gemm: no kernel {kernel!r}")
    _check(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: kernel {kernel!r} on device {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gemm: operands must be contiguous (row-major)")
    m, k = x.shape
    n = y.shape[1]
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    choice = choose_kernel(x.dtype, m, n, k, aligned)
    if kernel is None:
        kernel = choice
    elif x.dtype != _DTYPES[kernel]:
        raise TypeError(f"gemm: the {kernel} kernel takes {_DTYPES[kernel]}, not {x.dtype}")
    elif kernel in ("wgmma", "decode") and choice == "mma":
        raise ValueError(f"gemm: the {kernel} kernel takes K > 0, K % 8 == 0, N % 8 == 0 and "
                         f"16-byte aligned operands, not K = {k}, N = {n}, aligned = {aligned}")
    elif kernel == "decode" and m > WGMMA_MIN_M:
        raise ValueError(f"gemm: the decode kernel takes M <= {WGMMA_MIN_M}, not {m}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), 1, m, k, n)  # E = 1, C, D, F
    with on_device(x.device):
        if kernel == "tf32x3":  # raises on a launch error
            launch_f32(x, y, out, 1, m, n, k)
        else:
            stream = raw_stream(x.device)
            if kernel == "wgmma":
                err = _entry("repro_moe_gmm_wgmma_bf16")(*args, stream)
            elif kernel == "decode":
                err = _entry("repro_moe_gmm_decode_bf16")(*args, stream)
            else:
                vec = int(k % 8 == 0 and n % 8 == 0 and aligned)
                err = _entry("repro_moe_gmm_bf16")(*args, vec, stream)
            if err != 0:
                raise RuntimeError(f"gemm {kernel} kernel launch failed with error {err}")
    LAUNCHES["gemm"] += 1
    PATHS[kernel] += 1
    return out
