"""Public wrappers around the port's kernels (port of ``repro/kernels/ops.py``).

* ``matmul`` — K1 on a 2-D product; ``einsum2`` — the daisy codegen's hook
  into K1: a clean 2-operand contraction -> GEMM;
* ``rmsnorm`` — K4, ``attention`` — K5, ``grouped_matmul`` — K6: the model
  stack's kernels.

On CUDA tensors each launches its kernel or raises; on CPU tensors it takes
the plain version of ``kernels.ref`` (attention switches to the chunked one
above ``CHUNKED_ATTN_THRESHOLD`` score elements, as the reference's ``xla``
path does).  The device decides: there is no ``backend=`` switch.  The models
keep their projections as ``x @ w`` on cuBLAS, as the reference computes them
outside any Pallas kernel.

The classifier (``einsum2_reject_reason``) is separate from the lowering so
the codegen can decide before any launch whether a contraction goes to the
GEMM kernel; the reference instead calls ``einsum2`` and swallows whatever it
raises.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import ref
from .gemm import gemm
from .moe_gmm import grouped_matmul  # noqa: F401
from .rmsnorm import rmsnorm  # noqa: F401


def matmul(x, y, *, tile=None):
    """``x @ y`` of 2-D float32/bfloat16 tensors with an fp32 accumulator, in
    ``x.dtype``: K1 on the card, ``kernels.ref.matmul`` on the CPU.  ``tile``
    (a plan's TPU block shape) is accepted and ignored: K1's tiling is fixed."""
    return gemm(x, y)


# Above this many score elements (Sq*Skv) the CPU path switches to the
# chunked online-softmax formulation (bounded working set).
CHUNKED_ATTN_THRESHOLD = 1 << 22


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q (BHq, Sq, D), k/v (BHkv, Skv, D) -> (BHq, Sq, D); see
    ``kernels.flash_attention`` for ``q_offset``."""
    if q.device.type == "cpu" and q.shape[1] * k.shape[1] > CHUNKED_ATTN_THRESHOLD \
            and q.shape[1] > 1:
        _fa.PLAIN["flash_attention"] += 1
        off = _fa.expand_offsets(q_offset, q.shape[0], q.device)
        return ref.attention_chunked(q, k, v, causal=causal, window=window, q_offset=off)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def einsum2_reject_reason(sub_a: str, sub_b: str, sub_out: str) -> str | None:
    """None when ``sub_a,sub_b->sub_out`` is a clean 2-operand contraction
    (every letter contracted or kept exactly once, at least one contracted,
    no batch letter); otherwise why not."""
    if len(set(sub_a)) != len(sub_a) or len(set(sub_b)) != len(sub_b):
        return "repeated letter in an operand"
    if any(l in sub_b and l in sub_out for l in sub_a):
        return "batch letter (in both operands and the output)"
    if any(l not in sub_out and not (l in sub_a and l in sub_b) for l in sub_a + sub_b):
        return "letter summed within one operand"
    if sorted(sub_out) != sorted(l for l in sub_a + sub_b if l in sub_out):
        return "output letter missing from the operands"
    if not any(l in sub_b for l in sub_a):
        return "no contracted letter (an outer product)"
    return None


def einsum2(sub_a: str, sub_b: str, sub_out: str, a: torch.Tensor, b: torch.Tensor):
    """Lower a clean 2-operand contraction to the GEMM kernel.

    Raises ``ValueError`` for anything else (batch letters included): callers
    check ``einsum2_reject_reason`` first and use ``torch.einsum`` instead.
    """
    reason = einsum2_reject_reason(sub_a, sub_b, sub_out)
    if reason is not None:
        raise ValueError(f"not a clean 2-operand contraction: {reason}")
    contracted = [l for l in sub_a if l in sub_b and l not in sub_out]
    kept_a = [l for l in sub_a if l in sub_out]
    kept_b = [l for l in sub_b if l in sub_out and l not in kept_a]

    # contracted letters last in a, first in b; flatten both to 2-D
    perm_a = [sub_a.index(l) for l in kept_a] + [sub_a.index(l) for l in contracted]
    perm_b = [sub_b.index(l) for l in contracted] + [sub_b.index(l) for l in kept_b]
    size = {**{l: a.shape[sub_a.index(l)] for l in sub_a},
            **{l: b.shape[sub_b.index(l)] for l in sub_b}}
    ka = 1
    for l in kept_a:
        ka *= size[l]
    kc = 1
    for l in contracted:
        kc *= size[l]
    kb = 1
    for l in kept_b:
        kb *= size[l]
    a2 = a.permute(perm_a).reshape(ka, kc).contiguous()
    b2 = b.permute(perm_b).reshape(kc, kb).contiguous()
    out = gemm(a2, b2).reshape([size[l] for l in kept_a + kept_b])
    cur = kept_a + kept_b
    return out.permute([cur.index(l) for l in sub_out])
