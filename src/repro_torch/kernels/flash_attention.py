"""K5: the CUDA flash attention (forward) of the model stack.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas TPU
kernel).  The kernel is ``repro_torch/csrc/flash_attention.cu``: q
``(BHq, Sq, D)``, k/v ``(BHkv, Skv, D)`` with GQA by ``b // (BHq / BHkv)``,
causal masking against ``q_offset + i``, an optional sliding window, an
online softmax in fp32, any ``D <= 256``.

``q_offset`` is an int, or an int tensor of one offset per group of q rows
(one per slot on the serving path: ``n`` entries with ``BHq % n == 0``),
expanded here to one offset per q row.  Each row then walks only the keys it
can see.

``flash_attention`` launches the kernel for CUDA tensors and takes
``kernels.ref.attention`` for CPU tensors only.  ``LAUNCHES`` counts kernel
launches and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library

LAUNCHES = {"flash_attention": 0}
PLAIN = {"flash_attention": 0}

_DTYPES = {torch.float32: "repro_flash_f32", torch.bfloat16: "repro_flash_bf16"}
MAX_HEAD = 256
ROWS_PER_BLOCK = 4  # csrc/flash_attention.cu: R


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


@functools.cache
def _entry(dtype: torch.dtype):
    fn = getattr(cuda_library("flash_attention"), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """Attention over (BH, S, D) tensors (GQA via BHq = g * BHkv)."""
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"flash_attention: {bhq} q rows for {bhkv} kv rows")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                        "(want one of float32, bfloat16)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    off = expand_offsets(q_offset, bhq, q.device)
    if q.device.type == "cpu":
        PLAIN["flash_attention"] += 1
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=off)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d > MAX_HEAD:
        raise ValueError(f"flash_attention: head size {d} > {MAX_HEAD}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # few blocks (decode: one per slot and KV head) get 16 warps each to
    # split the KV walk; many blocks (prefill) get 4
    blocks = -(-(bhq // bhkv) * sq // ROWS_PER_BLOCK) * bhkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nwarps = 16 if blocks < 2 * sms else 4
    offs_ptr, off0 = (off.data_ptr(), 0) if isinstance(off, torch.Tensor) else (None, off)
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), offs_ptr, off0,
                 bhq, bhkv, sq, skv, d, int(bool(causal)), int(window is not None),
                 int(window or 0), float(1.0 / d ** 0.5), nwarps, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
