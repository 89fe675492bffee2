"""K6: the CUDA grouped matmul of the MoE layer's experts.

Port of ``repro/kernels/moe_gmm.py::grouped_matmul`` (the Pallas TPU kernel).
``out[e] = x[e] @ w[e]`` for x ``(E, C, D)`` and w ``(E, D, F)``, an fp32
accumulator over D, the output in x's type.  Four kernels compute it:

* ``"wgmma"`` — ``moe_gmm_wgmma_kernel`` in ``repro_torch/csrc/moe_gmm.cu``,
  bf16 on Hopper's warpgroup MMA fed by TMA, 128 x 256 output tiles: the
  prefill buckets, bound by operations;
* ``"decode"`` — ``moe_gmm_decode_kernel`` in the same file, bf16 with
  ``C < WGMMA_MIN_C``: one or two m16 row tiles, every warp on its own 32
  columns of a 256-column tile, the expert weights streamed by TMA through
  a 4-stage ring of 64-deep slices, each block over all of D: the decode
  step, bound by the weights' bytes;
* ``"mma"`` — ``moe_gmm_bf16_kernel`` in the same file, bf16 on ``mma.sync``
  m16n8k16 fragments with a ``cp.async`` ring, tiles as tall as C needs: any
  bf16 shape the other two do not take (D or F not a multiple of 8, an
  unaligned view);
* ``"gemm"`` — float32 on K1's 3xTF32 tensor-core kernel (``csrc/gemm.cu``,
  ``gemm.launch_f32``) with the expert as its batch axis.

``choose_kernel`` picks one from the dtype, C, D, F and the pointers'
alignment alone, before any launch.  Ragged C, D and F are masked inside the
kernels, so no padded copy is made (the reference pads to its block sizes).

``grouped_matmul_bwd`` is K6-bwd, the gradient (no TPU kernel: the
reference differentiates its plain version with XLA; the card needs a kernel
for ``loss.backward()``): ``moe_gmm_dx_wgmma_kernel`` writes ``dx = dy @
w^T`` and ``moe_gmm_dw_wgmma_kernel`` ``dw = x^T @ dy`` per expert, bf16 on
the wgmma kernel's pipeline (``wgmma`` fed by TMA, 128 x 256 tiles; w read
in place as a K-major operand, x^T as an MN-major one) with fp32
accumulators, one block an output tile over the whole k range, so the
gradients are bit-identical run to run.  It takes bf16 with D and F
multiples of 8 and 16-byte aligned contiguous tensors, and raises otherwise:
training on the card is bf16 only.

``grouped_matmul`` and ``grouped_matmul_bwd`` launch kernels for CUDA
tensors and take ``kernels.ref.grouped_matmul`` /
``kernels.ref.grouped_matmul_grad`` for CPU tensors only.  ``LAUNCHES``
counts launches per function (a backward call launches both of its
kernels), ``PATHS`` the launches of each kernel, and ``PLAIN`` the
plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import gemm, ref
from .build import cuda_library
from .runtime import on_device, raw_stream

LAUNCHES = {"grouped_matmul": 0, "grouped_matmul_bwd": 0}
PATHS = {"wgmma": 0, "decode": 0, "mma": 0, "gemm": 0, "dx": 0, "dw": 0}
PLAIN = {"grouped_matmul": 0, "grouped_matmul_bwd": 0}

# kernel -> (library, entry point, int arguments)
_ENTRIES = {"wgmma": ("moe_gmm", "repro_moe_gmm_wgmma_bf16", 4),    # e, c, d, f
            "decode": ("moe_gmm", "repro_moe_gmm_decode_bf16", 4),  # e, c, d, f
            "mma": ("moe_gmm", "repro_moe_gmm_bf16", 5),             # e, c, d, f, vec
            "dx": ("moe_gmm", "repro_moe_gmm_dx_bf16", 4),            # e, c, d, f
            "dw": ("moe_gmm", "repro_moe_gmm_dw_bf16", 4)}            # e, c, d, f
_DTYPES = {"wgmma": torch.bfloat16, "decode": torch.bfloat16, "mma": torch.bfloat16,
           "gemm": torch.float32}

# The wgmma kernel takes C from here up, the decode kernel below (see choose_kernel).
WGMMA_MIN_C = 32


def choose_kernel(dtype: torch.dtype, c: int, d: int, f: int, aligned: bool) -> str:
    """``"wgmma"``, ``"decode"``, ``"mma"`` or ``"gemm"`` for a grouped
    matmul of this dtype and shape; ``aligned``: x and w start on 16 bytes.

    float32 takes ``"gemm"``.  bf16 with ``D % 8 == 0``, ``F % 8 == 0`` and
    both pointers aligned (TMA's 16-byte row strides and addresses) takes
    the wgmma kernel when ``C >= WGMMA_MIN_C`` and the decode kernel below
    it, both fed by TMA; everything else takes the ``mma.sync`` kernel.

    The lines come from chip_smoke.py on an H100 80GB HBM3 at 700 W
    (PERF.md section 6).  From C = 40, the 128-token bucket, the wgmma
    kernel has been faster than the mma kernel at both of Mixtral 8x7B's
    widths in every recorded run (0.89-0.95 against 2.48-2.77 ms at a
    2048-token bucket's gate/up).  Below C = 32, the decode step (C = 16)
    and the warm-up (C = 2), the byte-bound decode kernel was the fastest
    of the three in two runs of chip_smoke.py in one call: at C = 16
    0.3060 device ms a call at gate/up and 0.2980-0.2987 at down (a CUDA
    graph of 20 calls), against wgmma's 0.3172-0.3190 / 0.3105-0.3115 and
    mma's 0.3394-0.3397 / 0.3126-0.3134; and the decode step with K6 on it
    took 18.91-18.95 device ms against 19.52-19.57 with K6 on wgmma and
    20.24-20.29 on mma (``decode_step_ab``).
    """
    if dtype == torch.float32:
        return "gemm"
    if not _wgmma_takes(dtype, d, f, aligned):
        return "mma"
    return "wgmma" if c >= WGMMA_MIN_C else "decode"


def _wgmma_takes(dtype: torch.dtype, d: int, f: int, aligned: bool) -> bool:
    return dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0 and aligned


@functools.cache
def _entry(kernel: str):
    lib, name, ints = _ENTRIES[kernel]
    fn = getattr(cuda_library(lib), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped_matmul: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype} "
                        "(want both float32 or both bfloat16)")
    if x.device != w.device:
        raise ValueError(f"grouped_matmul: x on {x.device}, w on {w.device}")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) per expert -> (E, C, F) in x's type."""
    _check(x, w)
    if x.device.type == "cpu":
        PLAIN["grouped_matmul"] += 1
        return ref.grouped_matmul(x, w)
    return _launch(None, x, w)


def _launch(kernel: str | None, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the named kernel (``"wgmma"``, ``"decode"``, ``"mma"`` or
    ``"gemm"``; ``None``: ``choose_kernel``'s pick) on CUDA tensors, or raise
    if it does not take them.  ``grouped_matmul`` goes through here with
    ``None``; the card tests and ``chip_smoke.py`` name a kernel to hold each
    against the plain version at any shape it takes."""
    if kernel is not None and kernel not in _DTYPES:
        raise ValueError(f"grouped_matmul: no kernel {kernel!r}")
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: kernel {kernel!r} on device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    e, c, d = x.shape
    f = w.shape[2]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if kernel is None:
        kernel = choose_kernel(x.dtype, c, d, f, aligned)
    elif x.dtype != _DTYPES[kernel]:
        raise TypeError(f"grouped_matmul: the {kernel} kernel takes {_DTYPES[kernel]}, "
                        f"not {x.dtype}")
    elif kernel in ("wgmma", "decode") and not _wgmma_takes(x.dtype, d, f, aligned):
        raise ValueError(f"grouped_matmul: the {kernel} kernel takes D % 8 == 0, F % 8 == 0 and "
                         f"16-byte aligned tensors, not D = {d}, F = {f}, aligned = {aligned}")
    elif kernel == "decode" and c > WGMMA_MIN_C:
        raise ValueError(f"grouped_matmul: the decode kernel takes C <= {WGMMA_MIN_C}, not {c}")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with on_device(x.device):
        if kernel == "gemm":  # raises on a launch error
            gemm.launch_f32(x, w, out, e, c, f, d)
        else:
            ints = (e, c, d, f) if kernel != "mma" else (
                e, c, d, f, int(d % 8 == 0 and f % 8 == 0 and aligned))
            err = _entry(kernel)(x.data_ptr(), w.data_ptr(), out.data_ptr(), *ints,
                                 raw_stream(x.device))
            if err != 0:
                raise RuntimeError(f"grouped_matmul {kernel} kernel launch failed with error {err}")
    LAUNCHES["grouped_matmul"] += 1
    PATHS[kernel] += 1
    return out


def check_bwd(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless K6-bwd takes the gradient of ``grouped_matmul(x, w)``
    on the card: bf16, D and F multiples of 8, 16-byte aligned tensors.  CPU
    tensors always pass (the plain version)."""
    _check(x, w)
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul_bwd: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"grouped_matmul_bwd: the backward kernels take bf16, not {x.dtype}: "
                        "MoE training on the card is bf16 only")
    d, f = w.shape[1], w.shape[2]
    if d % 8 or f % 8 or not (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        raise ValueError(f"grouped_matmul_bwd: the backward kernels take D % 8 == 0, F % 8 == 0 "
                         f"and 16-byte aligned tensors, not D = {d}, F = {f}")


def grouped_matmul_bwd(x: torch.Tensor, w: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6-bwd: the gradients ``(dx, dw)`` of ``grouped_matmul(x, w)`` for the
    output gradient ``dy`` (E, C, F) of x's type, ``dx`` in x's type and
    ``dw`` in w's."""
    check_bwd(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    if dy.shape != (e, c, f) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"grouped_matmul_bwd: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"for x {tuple(x.shape)} @ w {tuple(w.shape)} {x.dtype} on {x.device}")
    if x.device.type == "cpu":
        PLAIN["grouped_matmul_bwd"] += 1
        return ref.grouped_matmul_grad(x, w, dy)
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("grouped_matmul_bwd: x, w and dy must be contiguous")
    if dy.data_ptr() % 16:
        raise ValueError("grouped_matmul_bwd: dy must be 16-byte aligned")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if c == 0 or e == 0:
        return dx, dw.zero_()
    stream = raw_stream(x.device)
    with on_device(x.device):
        for kernel, args in (("dx", (dy, w, dx)), ("dw", (x, dy, dw))):
            err = _entry(kernel)(*(t.data_ptr() for t in args), e, c, d, f, stream)
            if err != 0:
                raise RuntimeError(f"grouped_matmul_bwd {kernel} kernel launch failed with "
                                   f"error {err}")
            PATHS[kernel] += 1
    LAUNCHES["grouped_matmul_bwd"] += 1
    return dx, dw
