"""K5: the CUDA flash attention (forward) of the model stack.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas TPU
kernel).  q ``(BHq, Sq, D)``, k/v ``(BHkv, Skv, D)`` with GQA by
``b // (BHq / BHkv)``, causal masking against ``q_offset + i``, an optional
sliding window, an online softmax in fp32.  Two kernels in
``repro_torch/csrc/flash_attention.cu`` compute it:

* ``"mma"`` — ``flash_mma_kernel``, bf16 on the tensor cores (``mma.sync``
  m16n8k16, a ``cp.async`` K/V ring), 128 q positions of one head per block:
  the bucketed prefill and ``forward``;
* ``"decode"`` — ``flash_decode_kernel``, bf16 with ``Sq == 1``: the KV
  range split across blocks (a block owns one KV head's GQA rows and one
  chunk of keys, streamed by TMA bulk copies), the chunks' softmax states
  merged in chunk order by the last block to arrive;
* ``"simt"`` — ``flash_kernel``, on the CUDA cores, 4 q rows per block, any
  ``D <= 256``, fp32 or bf16: whatever the other two do not take.

``choose_kernel`` picks one from the dtype, ``Sq``, ``D``, the GQA group and
the pointers' alignment alone, before any launch.

``q_offset`` is an int, or an int tensor of one offset per group of q rows
(one per slot on the serving path: ``n`` entries with ``BHq % n == 0``),
expanded here to one offset per q row.  Each row then walks only the keys it
can see.

Training (``flash_attention_fwd`` / ``flash_attention_bwd``, through
``ops.attention``'s autograd function): the tensor-core kernel also writes
each q row's log-sum-exp of its scaled scores (fp32, ``(BHq, Sq)``; ``+inf``
for a row that sees no key) when it is given somewhere to put it, which only
a forward under grad does.  K5-bwd is FlashAttention-2's backward in three
kernels of ``csrc/flash_attention.cu`` (no TPU kernel: the reference trains
on XLA's gradient of its plain version):

* ``"delta"`` — ``flash_bwd_delta_kernel``: ``delta = rowsum(dO * O)`` in fp32;
* ``"dkdv"`` — ``flash_bwd_dkdv_kernel``: a block per (KV head, 64 keys)
  walks the q rows of its GQA group that see those keys, recomputes
  ``P = exp(S scale - lse)`` and sums ``dV += P^T dO`` and
  ``dK += scale dS^T Q`` with ``dS = P (dO V^T - delta)``;
* ``"dq"`` — ``flash_bwd_dq_kernel``: a block per (q head, 64 rows) walks
  its visible keys and sums ``dQ += scale dS K``.

Each output element is summed by one warp in a fixed order: no atomics, and
the gradients are bit-identical run to run.  Every product runs on the tensor
cores (``mma.sync`` m16n8k16, bf16 tiles fed by ``cp.async`` rings, fp32
accumulators), with P and dS rounded to bf16 in registers before their
products, bf16 in and out; ``kernels.ref.attention_grad_mma`` follows that
order and rounding on the CPU.

``flash_attention`` and ``flash_attention_bwd`` launch kernels for CUDA
tensors and take ``kernels.ref.attention`` / ``kernels.ref.attention_grad``
for CPU tensors only.  ``LAUNCHES`` counts kernel launches (the forward's
kernels under ``flash_attention``, a backward call of three kernels once
under ``flash_attention_bwd``), ``PATHS`` the forward's launches of each
kernel, ``BWD_PATHS`` the backward's, and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import cuda_library
from .runtime import arrival_counters, on_device, raw_stream, sm_count

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
PATHS = {"mma": 0, "decode": 0, "simt": 0}
BWD_PATHS = {"delta": 0, "dkdv": 0, "dq": 0}
PLAIN = {"flash_attention": 0, "flash_attention_bwd": 0}

_SIMT_ENTRIES = {torch.float32: "repro_flash_f32", torch.bfloat16: "repro_flash_bf16"}
MAX_HEAD = 256      # csrc/flash_attention.cu: DMAX (flash_kernel)
MMA_MAX_HEAD = 128  # flash_mma_kernel: D padded to 128 in shared memory
ROWS_PER_BLOCK = 4  # csrc/flash_attention.cu: R (flash_kernel)
DECODE_MAX_GROUP = 16  # flash_decode_kernel: q rows of one KV head per block
DECODE_TILE = 64       # flash_decode_kernel: keys per K/V tile (DEC_TK)
DECODE_MAX_CHUNKS = 64  # and most chunks per KV head (DEC_MAX_CHUNKS)
DECODE_CHUNK = 256      # keys per decode block (decode_chunk)


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


def choose_kernel(dtype: torch.dtype, sq: int, d: int, aligned: bool, group: int = 1) -> str:
    """``"mma"``, ``"decode"`` or ``"simt"`` for attention of this dtype, q
    length, head size and GQA group (q heads per KV head); ``aligned``: q, k
    and v start on 16 bytes.

    The tensor-core kernel takes bf16 with ``Sq > 1``, ``D <= 128``,
    ``D % 8 == 0`` and aligned pointers: rows of ``D`` bf16 values then start
    on 16 bytes, which its ``cp.async`` copies need, and D pads to 128 in
    shared memory.  Timed on an H100 at Danube's heads over a 4096-position
    cache (chip_smoke.py phase 3, PERF.md), it was the faster kernel at every
    Sq from 2 to 64, the engine's 16- and 32-token buckets included.
    A decode step (``Sq == 1``) under the same conditions, with a group of
    at most 16, goes to the split-KV decode kernel: on that H100 (two runs
    of chip_smoke.py in one call) it took 0.044 ms of device time a call at
    Danube's 8 slots over a 4096-position cache against the SIMT kernel's
    0.178 and SDPA's 0.199-0.200 (a CUDA graph of 20 calls), and a Danube
    decode step from 7.75 to 6.17-6.21 device ms (``decode_step_ab``).
    Everything else goes to the SIMT kernel: fp32, ``D > 128`` or
    ``D % 8 != 0``, a group above 16, unaligned views.  No main-path shape
    falls there: the dense and MoE configs' heads are 64-128 wide (Danube
    120, Mixtral 128) with groups of 4, and the model stack hands K5 fresh
    tensors or views of whole cache rows, all aligned.
    """
    if not _mma_takes(dtype, d, aligned):
        return "simt"
    if sq > 1:
        return "mma"
    return "decode" if group <= DECODE_MAX_GROUP else "simt"


def decode_chunk(skv: int) -> int:
    """Keys per block of the decode kernel over a cache of ``skv``
    positions: ``DECODE_CHUNK``, or the fewest keys (a multiple of the
    64-key tile) that keep a KV head to ``DECODE_MAX_CHUNKS`` chunks.  Pure,
    decided before launch: the live chunks depend on the offsets, which stay
    on the device.

    256 keys give a 4096-position cache 16 chunks a KV head: 1,024 blocks
    at Danube's 8 slots and 2,048 at Mixtral's 16, a few waves at three
    blocks an SM.  Smaller chunks pay each block's fixed costs (its
    prologue and a merge input) more often; larger ones leave too few
    blocks when the slots are short."""
    fit = -(-skv // (DECODE_MAX_CHUNKS * DECODE_TILE)) * DECODE_TILE
    return max(DECODE_CHUNK, fit)


def decode_rows(group: int) -> int:
    """q rows a decode block holds: the GQA group padded to 4, 8 or 16."""
    return 4 if group <= 4 else 8 if group <= 8 else 16


def _mma_takes(dtype: torch.dtype, d: int, aligned: bool) -> bool:
    return dtype == torch.bfloat16 and d <= MMA_MAX_HEAD and d % 8 == 0 and aligned


@functools.cache
def _entry(kernel: str, dtype: torch.dtype):
    if kernel == "mma":  # the lse pointer (null: not written) before the stream
        fn = cuda_library("flash_attention").repro_flash_mma_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    elif kernel == "bwd":  # q k v o do lse dq dk dv delta offs, off0 + 8 ints, scale
        fn = cuda_library("flash_attention").repro_flash_bwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    elif kernel == "decode":  # no Sq; the chunk, the workspace and the counters
        fn = cuda_library("flash_attention").repro_flash_decode_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)
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


def flash_attention_fwd(q, k, v, *, causal=True, window=None, q_offset=0):
    """``(out, lse)``: the attention and each q row's log-sum-exp of its
    scaled scores (fp32 ``(BHq, Sq)``, ``+inf`` where a row sees no key),
    what the backward needs.  On the card only the tensor-core kernel writes
    the log-sum-exp, so anything it does not take raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        PLAIN["flash_attention"] += 1
        off = expand_offsets(q_offset, q.shape[0], q.device)
        return (ref.attention(q, k, v, causal=causal, window=window, q_offset=off),
                ref.attention_lse(q, k, causal=causal, window=window, q_offset=off))
    if q.shape[1] < 2:
        raise ValueError("flash_attention_fwd: the log-sum-exp comes from the tensor-core "
                         f"kernel, which takes Sq > 1, not Sq = {q.shape[1]}")
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _launch("mma", q, k, v, causal=causal, window=window, q_offset=q_offset,
                   lse=lse), lse


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True, window=None, q_offset=0):
    """K5-bwd: ``(dq, dk, dv)`` of attention for the output gradient ``dout``,
    given the forward's ``out`` and ``lse`` (``flash_attention_fwd``).  On the
    card: bf16, ``D <= 128``, ``D % 8 == 0``, 16-byte aligned contiguous
    tensors, ``Skv >= Sq``; anything else raises."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if q.device.type == "cpu":
        PLAIN["flash_attention_bwd"] += 1
        off = expand_offsets(q_offset, q.shape[0], q.device)
        return ref.attention_grad(q, k, v, dout, causal=causal, window=window, q_offset=off)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    dout = dout.contiguous()
    tensors = (q, k, v, out, dout, lse)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_bwd: q, k, v, out and lse must be contiguous")
    if not (q.dtype == out.dtype == dout.dtype == torch.bfloat16 and lse.dtype == torch.float32):
        raise TypeError(f"flash_attention_bwd: the backward kernels take bf16 q, k, v, out and "
                        f"dout and an fp32 lse, not {q.dtype}, {out.dtype}, {dout.dtype}, "
                        f"{lse.dtype}")
    if d > MMA_MAX_HEAD or d % 8 or not _aligned(q, k, v, out, dout):
        raise ValueError(f"flash_attention_bwd: the backward kernels take D <= {MMA_MAX_HEAD}, "
                         f"D % 8 == 0 and 16-byte aligned tensors, not D = {d}")
    if skv < sq:
        raise ValueError(f"flash_attention_bwd: Skv = {skv} < Sq = {sq}")
    off = expand_offsets(q_offset, bhq, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
    offs_ptr, off0 = (off.data_ptr(), 0) if isinstance(off, torch.Tensor) else (None, off)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            offs_ptr, off0, bhq, bhkv, sq, skv, d, int(bool(causal)), int(window is not None),
            int(window or 0), float(1.0 / d ** 0.5)]
    with on_device(q.device):
        err = _entry("bwd", q.dtype)(*args, raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    for name in BWD_PATHS:
        BWD_PATHS[name] += 1
    return dq, dk, dv


def _launch(kernel: str | None, q, k, v, *, causal=True, window=None, q_offset=0,
            chunk: int | None = None, lse: torch.Tensor | None = None):
    """Launch the named kernel (``"mma"``, ``"decode"`` or ``"simt"``;
    ``None``: ``choose_kernel``'s pick) on CUDA tensors, or raise if it does
    not take them.  ``flash_attention`` goes through here with ``None``; the
    card tests and ``chip_smoke.py`` name a kernel to hold each against the
    plain version, and may name the decode kernel's ``chunk`` (None:
    ``decode_chunk``'s pick).  ``lse`` (fp32 ``(BHq, Sq)``; the tensor-core
    kernel only) receives each row's log-sum-exp."""
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
    group = bhq // bhkv
    if kernel is None:
        kernel = choose_kernel(q.dtype, sq, d, aligned, group)
    elif kernel in ("mma", "decode") and not _mma_takes(q.dtype, d, aligned):
        raise ValueError(f"flash_attention: the {kernel} kernel takes bf16, D <= {MMA_MAX_HEAD}, "
                         f"D % 8 == 0 and 16-byte aligned tensors, not {q.dtype}, D = {d}")
    elif kernel == "decode" and (sq != 1 or group > DECODE_MAX_GROUP):
        raise ValueError(f"flash_attention: the decode kernel takes Sq == 1 and a group of at "
                         f"most {DECODE_MAX_GROUP}, not Sq = {sq}, group = {group}")
    if lse is not None and (kernel != "mma" or lse.shape != (bhq, sq)
                            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: the {kernel} kernel writes no log-sum-exp, or lse "
                         f"{tuple(lse.shape)} {lse.dtype} is not fp32 ({bhq}, {sq})")
    off = expand_offsets(q_offset, bhq, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    offs_ptr, off0 = (off.data_ptr(), 0) if isinstance(off, torch.Tensor) else (None, off)
    shape = [bhq, bhkv] + ([skv] if kernel == "decode" else [sq, skv])  # decode: Sq is 1
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), offs_ptr, off0, *shape,
            d, int(bool(causal)), int(window is not None), int(window or 0),
            float(1.0 / d ** 0.5)]
    ws = None  # held until the launch is queued
    if kernel == "decode":
        if chunk is None:
            chunk = decode_chunk(skv)
        if chunk < DECODE_TILE or chunk % DECODE_TILE or -(-skv // chunk) > DECODE_MAX_CHUNKS:
            raise ValueError(f"flash_attention: decode chunk {chunk} for {skv} keys")
        # per (KV head, chunk): (m, l) and the accumulator of each row, fp32
        ws = torch.empty(max(1, -(-skv // chunk)) * bhkv * decode_rows(group) * (2 + MMA_MAX_HEAD),
                         dtype=torch.float32, device=q.device)
        args += [chunk, ws.data_ptr(), arrival_counters(q.device, bhkv).data_ptr()]
    if kernel == "mma":
        args.append(lse.data_ptr() if lse is not None else None)
    if kernel == "simt":
        # few blocks (decode: one per slot and KV head) get 16 warps each to
        # split the KV walk; many blocks get 4
        blocks = -(-(bhq // bhkv) * sq // ROWS_PER_BLOCK) * bhkv
        args.append(16 if blocks < 2 * sm_count(q.device) else 4)
    with on_device(q.device):
        err = _entry(kernel, q.dtype)(*args, raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    PATHS[kernel] += 1
    return out
