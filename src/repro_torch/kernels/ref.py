"""Plain torch versions of the model-stack kernels (port of ``repro/kernels/ref.py``).

They are what the wrappers in ``ops`` take for CPU tensors, and what
``chip_smoke.py`` holds K1, K4, K5 and K6 against on the card.  Same masking and the
same fp32 arithmetic as the reference: scores and softmax in fp32, rows with
no visible key give 0.

``q_offset`` is an int, or an int tensor of one offset per q row (``BHq``
entries) — the serving path gives every slot its own cache length.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # the kernels' masked score (csrc/flash_attention.cu)


def matmul(x, y):
    """``x @ y`` with an fp32 accumulator, returned in ``x.dtype`` (K1's)."""
    return (x.to(torch.float32) @ y.to(torch.float32)).to(x.dtype)


def _repeat_kv(k, v, bhq):
    group = bhq // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    return k, v


def _q_pos(q_offset, bhq: int, rows: torch.Tensor) -> torch.Tensor:
    """Absolute positions of q rows: ``(1 or BHq, len(rows), 1)``."""
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(device=rows.device, dtype=torch.int64).reshape(-1)
        if off.numel() != bhq:
            raise ValueError(f"q_offset has {off.numel()} entries for {bhq} q rows")
        return off[:, None, None] + rows[None, :, None]
    return (int(q_offset) + rows)[None, :, None]


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    mask = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape), dtype=torch.bool,
                      device=k_pos.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (BHq, Sq, D); k, v: (BHkv, Skv, D), GQA by head-group repetition."""
    bhq, sq, d = q.shape
    skv = k.shape[1]
    k, v = _repeat_kv(k, v, bhq)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    q_pos = _q_pos(q_offset, bhq, torch.arange(sq, device=q.device))
    k_pos = torch.arange(skv, device=q.device)[None, None, :]
    mask = _mask(q_pos, k_pos, causal, window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))  # no visible key -> 0
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                      block_q=512, block_k=1024):
    """Online-softmax attention over (block_q, block_k) tiles, so the live
    score tensor is (BHq, block_q, block_k) instead of (BHq, Sq, Skv).

    Matches ``attention``.  KV blocks that no row of a q block can see are
    skipped; they would change neither the running max nor the sums.
    """
    bhq, sq, d = q.shape
    skv = k.shape[1]
    k, v = _repeat_kv(k, v, bhq)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    out = torch.empty_like(q)
    for q0 in range(0, sq, block_q):
        qc = q[:, q0:q0 + block_q].float()
        bq = qc.shape[1]
        q_pos = _q_pos(q_offset, bhq, torch.arange(q0, q0 + bq, device=dev))
        lo_pos, hi_pos = int(q_pos.min()), int(q_pos.max())
        m = torch.full((bhq, bq), float("-inf"), device=dev)
        l = torch.zeros((bhq, bq), device=dev)
        acc = torch.zeros((bhq, bq, d), device=dev)
        for k0 in range(0, skv, block_k):
            k1 = min(skv, k0 + block_k)
            if causal and k0 > hi_pos:
                continue
            if window is not None and k1 - 1 <= lo_pos - window:
                continue
            k_pos = torch.arange(k0, k1, device=dev)[None, None, :]
            mask = _mask(q_pos, k_pos, causal, window)
            s = torch.einsum("bqd,bkd->bqk", qc, k[:, k0:k1].float()) * scale
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), torch.zeros((), device=dev), m_new)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), torch.zeros((), device=dev))
            alpha = torch.where(torch.isneginf(m), torch.zeros((), device=dev),
                                torch.exp(m - m_safe))
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, v[:, k0:k1].float())
            m = m_new
        safe = torch.where(l == 0.0, torch.ones((), device=dev), l)
        out[:, q0:q0 + bq] = (acc / safe[..., None]).to(q.dtype)
    return out


def attention_decode_split(q, k, v, *, causal=True, window=None, q_offset=0, chunk=128):
    """Decode attention (``Sq == 1``) in the split-KV decode kernel's order:
    each chunk of ``chunk`` keys gives its own online-softmax state (its max
    m, its sum l of exp(s - m), and P rounded to v's type times V in fp32),
    and the chunks' states are merged in chunk order with the factors
    exp(m_c - M).  A row that sees no key gives 0.  Same arguments as
    ``attention``; the kernel's own chunk is a multiple of 64 keys, any
    ``chunk`` >= 1 is taken here."""
    bhq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"attention_decode_split: Sq = {sq}, want 1")
    skv = k.shape[1]
    k, v = _repeat_kv(k, v, bhq)
    dev = q.device
    s = torch.einsum("bd,bkd->bk", q[:, 0].float(), k.float()) / (d ** 0.5)
    mask = _mask(_q_pos(q_offset, bhq, torch.arange(1, device=dev))[:, 0],
                 torch.arange(skv, device=dev)[None, :], causal, window)
    mask = mask.expand(bhq, skv)
    neg = torch.full((), NEG_INF, device=dev)
    m_tot = torch.full((bhq,), NEG_INF, device=dev)
    states = []
    for k0 in range(0, skv, chunk):
        sc, mc = s[:, k0:k0 + chunk], mask[:, k0:k0 + chunk]
        m = torch.where(mc, sc, neg).amax(dim=-1)
        p = torch.where(mc, torch.exp(sc - m[:, None]), torch.zeros((), device=dev))
        acc = torch.einsum("bk,bkd->bd", p.to(v.dtype).float(), v[:, k0:k0 + chunk].float())
        states.append((m, p.sum(dim=-1), acc))
        m_tot = torch.maximum(m_tot, m)
    l_tot = torch.zeros(bhq, device=dev)
    acc_tot = torch.zeros(bhq, d, device=dev)
    for m, l, acc in states:  # chunk order
        f = torch.exp(m - m_tot)
        l_tot = l_tot + l * f
        acc_tot = acc_tot + acc * f[:, None]
    safe = torch.where(l_tot == 0.0, torch.ones((), device=dev), l_tot)
    return (acc_tot / safe[:, None]).to(q.dtype)[:, None]


def grouped_matmul(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F): each expert's product in fp32,
    returned in x's type."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rmsnorm(x, gamma, *, eps=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)
