"""K5: the CUDA flash attention (forward) of the model stack.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas TPU
kernel).  q ``(BHq, Sq, D)``, k/v ``(BHkv, Skv, D)`` with GQA by
``b // (BHq / BHkv)``, causal masking against ``q_offset + i``, an optional
sliding window, an online softmax in fp32.  Two kernels in
``repro_torch/csrc/flash_attention.cu`` compute it:

* ``"mma"`` — ``flash_mma_kernel``, bf16 on the tensor cores (``mma.sync``
  m16n8k16, a ``cp.async`` K/V ring), 128 q positions of one head per block:
  the bucketed prefill and ``forward``;
* ``"simt"`` — ``flash_kernel``, on the CUDA cores, 4 q rows per block, any
  ``D <= 256``, fp32 or bf16: decode (``Sq == 1``) and whatever the first
  does not take.

``choose_kernel`` picks one from the dtype, ``Sq``, ``D`` and the pointers'
alignment alone, before any launch.

``q_offset`` is an int, or an int tensor of one offset per group of q rows
(one per slot on the serving path: ``n`` entries with ``BHq % n == 0``),
expanded here to one offset per q row.  Each row then walks only the keys it
can see.

``flash_attention`` launches a kernel for CUDA tensors and takes
``kernels.ref.attention`` for CPU tensors only.  ``LAUNCHES`` counts kernel
launches (both kernels), ``PATHS`` the launches of each, and ``PLAIN`` the
plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library

LAUNCHES = {"flash_attention": 0}
PATHS = {"mma": 0, "simt": 0}
PLAIN = {"flash_attention": 0}

_SIMT_ENTRIES = {torch.float32: "repro_flash_f32", torch.bfloat16: "repro_flash_bf16"}
MAX_HEAD = 256      # csrc/flash_attention.cu: DMAX (flash_kernel)
MMA_MAX_HEAD = 128  # flash_mma_kernel: D padded to 128 in shared memory
ROWS_PER_BLOCK = 4  # csrc/flash_attention.cu: R (flash_kernel)


def expand_offsets(q_offset, bhq: int, device) -> int | torch.Tensor:
    """An int stays an int; a tensor of ``n`` offsets (``bhq % n == 0``)
    becomes an int32 tensor of one offset per q row on ``device`` (returned as
    it is when it already is one)."""
    if not isinstance(q_offset, torch.Tensor):
        return int(q_offset)
    off = q_offset.reshape(-1)
    n = off.numel()
    if n == 0 or bhq % n:
        raise ValueError(f"q_offset has {n} entries, which do not divide {bhq} q rows")
    off = off.to(device=device, dtype=torch.int32)
    return off if n == bhq else off.repeat_interleave(bhq // n)


def choose_kernel(dtype: torch.dtype, sq: int, d: int, aligned: bool) -> str:
    """``"mma"`` or ``"simt"`` for attention of this dtype, q length and head
    size; ``aligned``: q, k and v start on 16 bytes.

    The tensor-core kernel takes bf16 with ``Sq > 1``, ``D <= 128``,
    ``D % 8 == 0`` and aligned pointers: rows of ``D`` bf16 values then start
    on 16 bytes, which its ``cp.async`` copies need, and D pads to 128 in
    shared memory.  Timed on an H100 at Danube's heads over a 4096-position
    cache (chip_smoke.py phase 3, PERF.md), it was the faster kernel at every
    Sq from 2 to 64, the engine's 16- and 32-token buckets included.
    Everything else goes to the SIMT kernel: decode (``Sq == 1``, where it
    splits one q row's KV walk over 16 warps and holds the step level with
    SDPA), fp32, ``D > 128`` or ``D % 8 != 0``, unaligned views.  No main-path
    shape falls there except decode: the dense and MoE configs' heads are
    64-128 wide (Danube 120, Mixtral 128), and the model stack hands K5 fresh
    tensors or views of whole cache rows, all aligned.
    """
    return "mma" if sq > 1 and _mma_takes(dtype, d, aligned) else "simt"


def _mma_takes(dtype: torch.dtype, d: int, aligned: bool) -> bool:
    return dtype == torch.bfloat16 and d <= MMA_MAX_HEAD and d % 8 == 0 and aligned


@functools.cache
def _entry(kernel: str, dtype: torch.dtype):
    if kernel == "mma":
        fn = cuda_library("flash_attention").repro_flash_mma_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    else:  # the SIMT entries also take the number of warps
        fn = getattr(cuda_library("flash_attention"), _SIMT_ENTRIES[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bhq, bhkv = q.shape[0], k.shape[0]
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"flash_attention: {bhq} q rows for {bhkv} kv rows")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SIMT_ENTRIES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                        "(want one of float32, bfloat16)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Attention over (BH, S, D) tensors (GQA via BHq = g * BHkv)."""
    if q.device.type == "cpu":
        _check(q, k, v)
        PLAIN["flash_attention"] += 1
        off = expand_offsets(q_offset, q.shape[0], q.device)
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=off)
    return _launch(None, q, k, v, causal=causal, window=window, q_offset=q_offset)


def _launch(kernel: str | None, q, k, v, *, causal=True, window=None, q_offset=0):
    """Launch the named kernel (``"mma"`` or ``"simt"``; ``None``:
    ``choose_kernel``'s pick) on CUDA tensors, or raise if it does not take
    them.  ``flash_attention`` goes through here with ``None``; the card tests
    and ``chip_smoke.py`` name a kernel to hold each against the plain
    version."""
    if kernel is not None and kernel not in PATHS:
        raise ValueError(f"flash_attention: no kernel {kernel!r}")
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: kernel {kernel!r} on device {q.device}")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if d > MAX_HEAD:
        raise ValueError(f"flash_attention: head size {d} > {MAX_HEAD}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    aligned = _aligned(q, k, v)
    if kernel is None:
        kernel = choose_kernel(q.dtype, sq, d, aligned)
    elif kernel == "mma" and not _mma_takes(q.dtype, d, aligned):
        raise ValueError(f"flash_attention: the mma kernel takes bf16, D <= {MMA_MAX_HEAD}, "
                         f"D % 8 == 0 and 16-byte aligned tensors, not {q.dtype}, D = {d}")
    off = expand_offsets(q_offset, bhq, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    offs_ptr, off0 = (off.data_ptr(), 0) if isinstance(off, torch.Tensor) else (None, off)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), offs_ptr, off0,
            bhq, bhkv, sq, skv, d, int(bool(causal)), int(window is not None),
            int(window or 0), float(1.0 / d ** 0.5)]
    if kernel == "simt":
        # few blocks (decode: one per slot and KV head) get 16 warps each to
        # split the KV walk; many blocks get 4
        blocks = -(-(bhq // bhkv) * sq // ROWS_PER_BLOCK) * bhkv
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        args.append(16 if blocks < 2 * sms else 4)
    fn = _entry(kernel, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    PATHS[kernel] += 1
    return out
