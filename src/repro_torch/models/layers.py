"""Model building blocks (port of ``repro/models/layers.py:80-533``): rope,
attention (self- and cross-attention), the dense SwiGLU FFN, the MoE FFN, the
Mamba block (selective SSM, chunked scan) and the xLSTM blocks (mLSTM,
chunkwise-parallel; sLSTM, sequential).

Plain functions over dicts of tensors.  Attention goes through
``kernels.ops`` (K5 on the card), the MoE experts through
``ops.grouped_matmul`` (K6), projections stay ``x @ w`` in torch with
the reference's ``(d_in, d_out)`` weight layout, as the reference leaves them
to XLA outside any Pallas kernel.

Under a mesh (``launch.mesh.set_mesh``) the layers take this rank's shards
of the weights (``launch.sharding.shard_params``) and run explicit
collectives over ``model`` where the reference's ``constrain`` lets GSPMD
place them.  A weight is read as the unsharded model's: one whose input
dim is cut is row-parallel (``_mm``: this rank's slice of the input, the
partial products summed over ``model`` in fp32), one whose output dim is
cut gives this rank's columns.  A row-parallel partial leaves its GEMM in
fp32 (a bf16 GEMM's fp32 accumulator on the card) and is rounded once,
after the sum, as the unsharded GEMM rounds its own fp32 sum.  A dim is
taken for a shard only where it is the full one over the ``model`` axis
of the current mesh (``_split``); any other size raises.  Attention takes
its head counts from the local ``wq``/``wk``; ``wo`` is row-parallel.
Where the KV heads do not divide ``model``, ``wk``/``wv`` are cut on their
contracting dim and every rank computes every KV head, then keeps those
its query heads read (``sharding.attention_heads``).  The dense FFN is
column- then row-parallel, one all-reduce.  The MoE FFN routes all T
tokens on every rank (replicated router, the unsharded capacity), so its
dropped assignments are the unsharded ones.  Under expert parallelism a
rank fills and runs only its experts' rows of the dispatch buffer and the
ranks' combined outputs are summed.  Where the experts do not divide
``model`` their F is cut instead (the TP fallback) and the experts'
partial outputs are summed before the combine; K6 has rounded each
partial to the model's type, so that path rounds twice.  Without a mesh
the local shapes are the full ones and nothing is reduced.

KV caches are laid out ``(B, KV, S, Dh)`` — the reference's is
``(B, S, KV, Dh)`` — so that folding heads into K5's ``(B*KV, S, Dh)`` is a
view and not a copy of the whole cache on every step.  Caches are updated
in place.

The scans have no Pallas kernel in the reference and none here: they run on
torch ops.  The reference's ``lax.scan`` over chunks is a loop over chunks,
its ``lax.associative_scan`` within a chunk a log-step (Hillis-Steele) scan,
and the sLSTM's ``lax.scan`` over time a loop over time.  The recurrent blocks
return their new state; they never write the one they were given.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..launch import sharding as SH
from ..launch.mesh import current_mesh

Params = dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    # scaled in place: a Jamba expert tensor is 12.9 GB in fp32
    return torch.randn(shape, generator=gen, device=gen.device).mul_(s).to(dtype)


def _tp():
    """(ranks along ``model``, this rank's coordinate, its group) of the
    current mesh; (1, 0, None) without one."""
    return SH.model_shards(current_mesh())


def _split(n: int, full: int, what: str) -> bool:
    """Whether a dim the unsharded model has ``full`` of, of which this
    rank holds ``n``, is cut over ``model``: ``n`` is ``full`` over the
    current mesh's ``model`` axis.  Any other size raises, so a leaf of the
    wrong shape is never taken for a shard."""
    if n == full:
        return False
    m = _tp()[0]
    if m > 1 and n * m == full:
        return True
    raise ValueError(f"{what}: {n} of the model's {full}, with a model axis of {m}")


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with its fp32 sum unrounded: a bf16 GEMM writes its fp32
    accumulator on the card; on the CPU the same products in fp32."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _mm(x: torch.Tensor, w: torch.Tensor, full_in: int) -> torch.Tensor:
    """``x @ w`` of the unsharded model.  A weight whose input dim is cut
    (row-parallel) takes this rank's slice of ``x``'s last dim, unless
    ``x`` is that slice already; the partial products are summed over
    ``model`` in fp32 and rounded once to ``x``'s type, as the unsharded
    product rounds its fp32 sum."""
    k = w.shape[-2]
    if not _split(k, full_in, "a weight's input dim"):
        return x @ w
    _, r, group = _tp()
    if x.shape[-1] != k:
        x = x[..., r * k:(r + 1) * k]
    return SH.all_reduce_sum(_mm_f32(x, w), group).to(x.dtype)


def _bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b``; a bias cut over ``model`` on an output that is whole
    (the contracting-dim rule) is gathered first."""
    if _split(b.shape[-1], y.shape[-1], "a bias"):
        b = SH.all_gather_cat(b, _tp()[2])
    return y + b


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute positions."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None, None].to(torch.float32) * freqs  # (B, S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h * dh), dtype),
        "wk": _dense_init(gen, (d, kv * dh), dtype),
        "wv": _dense_init(gen, (d, kv * dh), dtype),
        "wo": _dense_init(gen, (h * dh, d), dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def write_cache(cache: torch.Tensor, new: torch.Tensor, write_pos) -> None:
    """Write ``new`` (B, KV, s, Dh) into ``cache`` (B, KV, S, Dh) at
    ``write_pos``: an int for every row, or a (B,) tensor (then s == 1).

    Like the reference's ``dynamic_update_slice``, the start is clamped to
    ``[0, S - s]``: an idle serving slot keeps advancing past the end of its
    cache, and its writes land on the last row.
    """
    s_cache, s = cache.shape[2], new.shape[2]
    if isinstance(write_pos, torch.Tensor):
        if s != 1:
            raise ValueError("per-row write positions need s == 1")
        pos = write_pos.clamp(0, s_cache - 1)
        cache[torch.arange(cache.shape[0], device=cache.device), :, pos] = new[:, :, 0]
    else:
        w = min(max(int(write_pos), 0), s_cache - s)
        cache[:, :, w:w + s] = new


def attention(
    x: torch.Tensor,  # (B, S, D)
    p: Params,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S) absolute positions (rope)
    causal: bool = True,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, KV, S_cache, Dh)
    write_pos: torch.Tensor | int = 0,
    attn_offset: torch.Tensor | int = 0,  # K5's q_offset: an int, or one per batch row
    memory: torch.Tensor | None = None,  # (B, S_mem, D): cross-attention
):
    """Sequence attention (cache=None), a cached step (cache given; written
    in place) or cross-attention (memory given, no cache).  The cache path
    passes ``window=None`` to the kernel, exactly as the reference does
    (``repro/models/layers.py:167``).  Cross-attention projects K and V from
    ``memory`` on every call, applies no rope, and runs K5 non-causal with no
    window and offset 0 (``repro/models/layers.py:134-171``)."""
    b, s, _ = x.shape
    dh = cfg.head_dim

    src = x if memory is None else memory
    q = _mm(x, p["wq"], x.shape[-1])
    k = _mm(src, p["wk"], src.shape[-1])
    v = _mm(src, p["wv"], src.shape[-1])
    if "bq" in p:
        q, k, v = _bias(q, p["bq"]), _bias(k, p["bk"]), _bias(v, p["bv"])
    h, kv = q.shape[-1] // dh, k.shape[-1] // dh  # this rank's heads
    q = q.view(b, s, h, dh)
    k = k.view(b, -1, kv, dh)
    v = v.view(b, -1, kv, dh)
    if _split(h, cfg.n_heads, "query heads") and not _split(kv, cfg.n_kv_heads, "KV heads"):
        # every KV head computed (contracting-dim rule): keep those of this
        # rank's query heads' GQA groups
        keep = torch.as_tensor(SH.attention_heads(cfg, current_mesh())[1], device=k.device)
        k, v = k.index_select(2, keep), v.index_select(2, keep)
        kv = keep.numel()
    if memory is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    # fold heads into batch: q (B*H, S, Dh); k/v (B*KV, Skv, Dh)
    qf = q.transpose(1, 2).reshape(b * h, s, dh).contiguous()
    if cache is not None:
        ck, cv = cache
        write_cache(ck, k.transpose(1, 2), write_pos)
        write_cache(cv, v.transpose(1, 2), write_pos)
        kf = ck.view(b * kv, ck.shape[2], dh)
        vf = cv.view(b * kv, cv.shape[2], dh)
    else:  # fresh tensors: K5 takes contiguous, 16-byte aligned operands
        kf = k.transpose(1, 2).reshape(b * kv, k.shape[1], dh).contiguous()
        vf = v.transpose(1, 2).reshape(b * kv, v.shape[1], dh).contiguous()
    of = ops.attention(
        qf, kf, vf, causal=causal and memory is None,
        window=cfg.window if (memory is None and cache is None) else None,
        q_offset=attn_offset if cache is not None else 0,
    )
    out = of.view(b, h, s, dh).transpose(1, 2).reshape(b, s, h * dh)
    return _mm(out, p["wo"], cfg.n_heads * dh)


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": _dense_init(gen, (d, f), dtype),
        "wu": _dense_init(gen, (d, f), dtype),
        "wd": _dense_init(gen, (f, d), dtype),
    }


def dense_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    return _mm(F.silu(x @ p["wg"]) * (x @ p["wu"]), p["wd"], cfg.d_ff)


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _dense_init(gen, (d, e), torch.float32),
        "wg": _dense_init(gen, (e, d, f), dtype),
        "wu": _dense_init(gen, (e, d, f), dtype),
        "wd": _dense_init(gen, (e, f, d), dtype),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert when ``n_tokens`` tokens are dispatched together."""
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to sublane multiple


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing: x (T, D) -> (gates (T, k) in x's type, experts (T, k)).
    Router logits in fp32; gates are the softmax over the top-k logits."""
    logits = x.float() @ router
    top, experts = torch.topk(logits, k, dim=-1)
    return torch.softmax(top, dim=-1).to(x.dtype), experts


def moe_dispatch(experts: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based dispatch of the flattened (token, choice) assignments.

    Returns ``(order, dest, keep)``: ``order`` sorts the assignments by expert,
    stable, so each expert's assignments stay in token order and capacity keeps
    the first ``capacity`` of them; ``dest`` is each sorted assignment's row of
    the ``(E * capacity)`` dispatch buffer, or ``E * capacity`` (an overflow
    row) where ``keep`` is False.  No host synchronisation.
    """
    fe = experts.reshape(-1)
    order = torch.argsort(fe, stable=True)  # jnp.argsort is stable, torch's default is not
    se = fe[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=fe.device)
    counts.scatter_add_(0, fe, torch.ones_like(fe))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(fe.numel(), device=fe.device) - starts[se]
    keep = pos < capacity
    dest = torch.where(keep, se * capacity + pos, n_experts * capacity)
    return order, dest, keep


def _training(*ts) -> bool:
    """Autograd will differentiate a result of these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Dispatch(torch.autograd.Function):
    """The dispatch buffer: row ``slot[t, j]`` of the ``(rows + 1, D)`` buffer
    is token t's row ``x[t]`` for its j-th choice (``rows``: the overflow row,
    dropped).  The backward gathers each token's k rows of the buffer's
    gradient and sums them in fp32 in choice order: indexing's backward would
    sum them with atomics, in x's type."""

    @staticmethod
    def forward(ctx, x, slot, rows: int):
        t, d = x.shape
        disp = x.new_zeros((rows + 1, d))
        disp.index_copy_(0, slot.reshape(-1), x.repeat_interleave(slot.shape[1], 0))
        ctx.save_for_backward(slot)
        return disp[:rows]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        gp = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return gp[slot].float().sum(1).to(g.dtype), None, None


def moe_route_dispatch(x: torch.Tensor, p: Params, cfg: ModelConfig,
                       capacity: int | None = None):
    """Route the tokens x (T, D) and fill the dispatch buffer: ``(disp (E, C,
    D), route)``, ``route`` what ``moe_combine`` needs.  ``capacity``
    defaults to ``moe_capacity(cfg, T)``, the reference's; assignments over it
    (capacity overflow) contribute 0.

    Serving (no grad): ``route`` is ``(dest, st, sg, keep)`` in expert order,
    the buffer filled by ``index_copy_``.  Under expert parallelism the
    buffer holds only this rank's experts, ``dest`` indexes it and ``keep``
    marks the kept assignments of those experts.  Training: ``route`` is
    ``(slot, gw)`` in token order, each token's k rows of the buffer (``E *
    C``: the overflow row) and gates with the dropped ones zeroed, so the
    backward of the dispatch and the combine sums each token's k
    contributions in fp32 in a fixed order (``_Dispatch``,
    ``moe_combine``)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(cfg, t) if capacity is None else capacity
    gates, experts = moe_route(x, p["router"], k)
    order, dest, keep = moe_dispatch(experts, e, c)
    if _training(x, *(p[n] for n in ("router", "wg", "wu", "wd"))):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        slot = dest[inv].view(t, k)
        gw = gates * keep[inv].view(t, k).to(gates.dtype)
        return _Dispatch.apply(x, slot, e * c).view(e, c, d), (slot, gw)
    el = p["wg"].shape[0]  # this rank's experts: rows [lo, lo + el * c) of the full buffer
    lo = _tp()[1] * el * c if _split(el, e, "experts") else 0
    keep = keep & (dest >= lo) & (dest < lo + el * c)
    dest = torch.where(keep, dest - lo, el * c)
    st = torch.div(order, k, rounding_mode="floor")  # token of each sorted assignment
    disp = x.new_zeros((el * c + 1, d))
    disp.index_copy_(0, dest, x[st])  # kept rows are distinct; the others land on el*c
    return disp[: el * c].view(el, c, d), (dest, st, gates.reshape(-1)[order], keep)


def moe_experts(disp: torch.Tensor, p: Params) -> torch.Tensor:
    """The experts' SwiGLU FFN on the dispatch buffer: three K6 products."""
    h = ops.grouped_matmul(disp, p["wg"])
    u = ops.grouped_matmul(disp, p["wu"])
    return ops.grouped_matmul(F.silu(h) * u, p["wd"])  # (E, C, D)


def moe_combine(y: torch.Tensor, route, t: int) -> torch.Tensor:
    """The experts' outputs y (E, C, D) back to the T tokens, gate-weighted."""
    e, c, d = y.shape
    y_flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))])
    if len(route) == 2:  # training: each token's k rows, summed in fp32 in choice order
        slot, gw = route
        return (y_flat[slot] * gw[..., None]).float().sum(1).to(y.dtype)
    dest, st, sg, keep = route
    contrib = y_flat[dest] * (sg * keep.to(sg.dtype))[:, None]
    return y.new_zeros((t, d)).index_add_(0, st, contrib)


def moe_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig,
            capacity: int | None = None) -> torch.Tensor:
    """Top-k token-choice MoE with static capacity (sort-based dispatch).

    x (T, D) -> (T, D).  ``capacity`` defaults to ``moe_capacity(cfg, T)``, the
    reference's; assignments over it (capacity overflow) contribute 0.  The
    batched decode passes ``capacity=T``, which drops nothing, as the
    reference's per-slot decode (T = 1, capacity 8) never does.  On a shard
    of the experts (serving), the sum over ``model`` follows the experts
    (their F cut: the TP fallback) or the combine (expert parallelism).
    """
    group = _tp()[2]
    disp, route = moe_route_dispatch(x, p, cfg, capacity)
    y = moe_experts(disp, p)
    if _split(p["wd"].shape[-2], cfg.d_ff, "the experts' wd rows"):
        y = SH.all_reduce_sum(y, group)
    out = moe_combine(y, route, x.shape[0])
    return SH.all_reduce_sum(out, group) if _split(p["wg"].shape[0], cfg.n_experts,
                                                   "experts") else out


# ---------------------------------------------------------------------------
# Mamba block (selective SSM, chunked scan)
# ---------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d = cfg.d_model
    din = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dt_rank = max(1, d // 16)
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d, 2 * din), dtype),
        "conv_w": _dense_init(gen, (cfg.mamba_d_conv, din), dtype, scale=0.5),
        "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, (din, dt_rank + 2 * n), dtype),
        "dt_proj": _dense_init(gen, (dt_rank, din), dtype),
        "dt_bias": torch.full((din,), -2.0, dtype=dtype, device=dev),  # softplus -> small dt
        # fp32 in every model, as in the reference
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                           ).repeat(din, 1),
        "Dskip": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": _dense_init(gen, (din, d), dtype),
    }


def _mamba_scan_chunked(dt, Bm, Cm, xc, A, h0, chunk: int):
    """Selective-SSM scan, one chunk at a time.

    dt, xc: (B, S, Din) fp32; Bm, Cm: (B, S, N) fp32; A: (Din, N); h0:
    (B, Din, N).  Returns y (B, S, Din) fp32 and the final state.  Only one
    chunk's (B, Q, Din, N) transitions ``exp(dt*A)`` and inputs ``dt*B*x`` are
    ever live: the carry is folded into the chunk's first input, a log-step
    scan of the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)
    gives every position's state, which is contracted with C at once.

    Without grad the chunk's tensors are updated in place.  Under grad each
    chunk runs ``_scan_chunk`` (the same operations, out of place, so no
    tensor autograd saved is overwritten) inside its own checkpoint, so the
    backward keeps each chunk's inputs and recomputes one chunk's graph at a
    time."""
    b, s, din = dt.shape
    q = min(chunk, s)
    assert s % q == 0
    if _training(dt, Bm, Cm, xc, A, h0):
        ys, h = [], h0
        for c0 in range(0, s, q):
            y, h = checkpoint(_scan_chunk, dt[:, c0:c0 + q], Bm[:, c0:c0 + q],
                              Cm[:, c0:c0 + q], xc[:, c0:c0 + q], A, h, use_reentrant=False)
            ys.append(y)
        return torch.cat(ys, dim=1), h
    y = torch.empty((b, s, din), dtype=torch.float32, device=dt.device)
    h = h0
    for c0 in range(0, s, q):
        dtc = dt[:, c0:c0 + q, :, None]
        a = torch.exp(dtc * A)  # (B, Q, Din, N)
        hs = dtc * Bm[:, c0:c0 + q, None, :] * xc[:, c0:c0 + q, :, None]
        hs[:, 0] += a[:, 0] * h
        step = 1
        while step < q:  # Hillis-Steele: after the step, each position holds 2*step inputs
            hs[:, step:] = hs[:, step:] + a[:, step:] * hs[:, :-step]
            if 2 * step < q:
                a[:, step:] = a[:, step:] * a[:, :-step]
            step *= 2
        y[:, c0:c0 + q] = torch.einsum("bqdn,bqn->bqd", hs, Cm[:, c0:c0 + q])
        h = hs[:, -1].clone()
    return y, h


def _scan_chunk(dtc, bc, cc, xcc, A, h):
    """One chunk of ``_mamba_scan_chunked`` out of place: (y (B, Q, Din), the
    state after it)."""
    q = dtc.shape[1]
    a = torch.exp(dtc[..., None] * A)
    hs = dtc[..., None] * bc[:, :, None, :] * xcc[..., None]
    hs = torch.cat([hs[:, :1] + a[:, :1] * h[:, None], hs[:, 1:]], dim=1)
    step = 1
    while step < q:
        hs = torch.cat([hs[:, :step], hs[:, step:] + a[:, step:] * hs[:, :-step]], dim=1)
        if 2 * step < q:
            a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return torch.einsum("bqdn,bqn->bqd", hs, cc), hs[:, -1]


def mamba(x: torch.Tensor, p: Params, cfg: ModelConfig,
          state: tuple[torch.Tensor, torch.Tensor] | None = None, chunk: int = 256):
    """x: (B, S, D) -> (out (B, S, D), (conv_buf (B, d_conv-1, Din), h (B, Din, N)
    fp32)).  With ``state`` the causal depthwise conv continues from its
    buffer and the scan from its h; S = 1 is one step of the recurrence."""
    b, s, d = x.shape
    din = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dt_rank = max(1, d // 16)

    x1, z = (x @ p["in_proj"]).split(din, dim=-1)  # (B, S, Din) each

    # causal depthwise conv, optionally continuing from a state buffer
    dconv = cfg.mamba_d_conv
    if state is not None:
        x_pad = torch.cat([state[0], x1], dim=1)
    else:
        x_pad = F.pad(x1, (0, 0, dconv - 1, 0))
    new_conv_buf = (x_pad[:, s:].clone() if dconv > 1
                    else x1.new_zeros((b, 0, din)))
    xc = sum(x_pad[:, i:i + s] * p["conv_w"][i] for i in range(dconv)) + p["conv_b"]
    xc = F.silu(xc)

    proj = xc @ p["x_proj"]  # (B, S, dt_rank + 2N)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])  # model dtype
    Bm = proj[..., dt_rank:dt_rank + n].float()
    Cm = proj[..., dt_rank + n:].float()

    A = -torch.exp(p["A_log"])  # (Din, N) fp32
    dtf, xcf = dt.float(), xc.float()
    h0 = (state[1] if state is not None
          else torch.zeros((b, din, n), dtype=torch.float32, device=x.device))
    # pad the sequence to a chunk multiple (dt = 0: the identity transition)
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        dtf, Bm, Cm, xcf = (F.pad(t, (0, 0, 0, pad)) for t in (dtf, Bm, Cm, xcf))
    y, h_last = _mamba_scan_chunked(dtf, Bm, Cm, xcf, A, h0, q)
    y = y[:, :s].to(x.dtype)
    y = y + p["Dskip"] * xc
    y = y * F.silu(z)
    return y @ p["out_proj"], (new_conv_buf, h_last)


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------
def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dev = gen.device
    return {
        "wq": _dense_init(gen, (d, d), dtype),
        "wk": _dense_init(gen, (d, d), dtype),
        "wv": _dense_init(gen, (d, d), dtype),
        "wi": _dense_init(gen, (d, h), dtype, scale=0.01),
        "wf": _dense_init(gen, (d, h), dtype, scale=0.01),
        "bi": torch.zeros((h,), dtype=dtype, device=dev),
        "bf": torch.full((h,), 3.0, dtype=dtype, device=dev),  # forget-gate bias: long memory
        "wo": _dense_init(gen, (d, d), dtype),
    }


def mlstm(x: torch.Tensor, p: Params, cfg: ModelConfig, state: tuple | None = None,
          chunk: int = 128):
    """Chunkwise-parallel mLSTM (matrix memory, gated linear attention), x:
    (B, S, D) -> (out, (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)), fp32 state).

    Stabilized in log space: within a chunk the decay matrix comes from the
    cumulative log forget gates; across chunks the memory C, the normalizer n
    and the stabilizer m are carried.  Padding to a chunk multiple takes
    ``logi = -1e30`` (no input), and a fresh state starts at ``m = -1e30``.
    """
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    f32 = torch.float32

    def heads(w):  # (B, S, D) -> (B, H, S, Dh)
        return w.view(b, s, h, dh).transpose(1, 2)

    q = heads(x @ p["wq"]) / math.sqrt(dh)
    k = heads(x @ p["wk"])
    v = heads(x @ p["wv"])
    logf = F.logsigmoid((x @ p["wf"] + p["bf"]).float()).transpose(1, 2)  # (B, H, S)
    logi = (x @ p["wi"] + p["bi"]).float().transpose(1, 2)

    qc = min(chunk, s)
    pad = (-s) % qc
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        logf = F.pad(logf, (0, pad))
        logi = F.pad(logi, (0, pad), value=-1e30)
    if state is None:
        C = torch.zeros((b, h, dh, dh), dtype=f32, device=x.device)
        n = torch.zeros((b, h, dh), dtype=f32, device=x.device)
        m = torch.full((b, h), -1e30, dtype=f32, device=x.device)
    else:
        C, n, m = state
    tri = torch.ones((qc, qc), dtype=torch.bool, device=x.device).tril()
    ys = torch.empty((b, h, s + pad, dh), dtype=f32, device=x.device)
    for c0 in range(0, s + pad, qc):
        sl = slice(c0, c0 + qc)
        qq, kk, vv = q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float()
        f, i_ = logf[:, :, sl], logi[:, :, sl]
        Fc = torch.cumsum(f, dim=-1)  # cumulative log-forget within the chunk
        logd_inter = Fc + m[..., None]  # decay applied to the carried memory
        # intra-chunk decay matrix: D[t, s] = F_t - F_s + i_s (s <= t)
        Dm = (Fc[..., :, None] - Fc[..., None, :] + i_[..., None, :]).masked_fill(~tri, -1e30)
        m_new = torch.maximum(logd_inter, Dm.amax(dim=-1))  # (B, H, Q) running stabilizer
        sc_inter = torch.exp(logd_inter - m_new)
        Pqk = torch.exp(Dm - m_new[..., None]) * (qq @ kk.transpose(-1, -2))  # (B, H, Q, Q)
        y_inter = sc_inter[..., None] * (qq @ C)
        norm = Pqk.sum(dim=-1) + sc_inter * (qq @ n[..., None])[..., 0]
        denom = torch.maximum(norm.abs(), torch.exp(-m_new))
        ys[:, :, sl] = (Pqk @ vv + y_inter) / denom[..., None]

        # the chunk's final state
        Ftot = Fc[..., -1:]  # (B, H, 1)
        src = Ftot - Fc + i_
        m_next = torch.maximum(Ftot[..., 0] + m, src.amax(dim=-1))
        w_src = torch.exp(src - m_next[..., None])  # (B, H, Q)
        decay = torch.exp(Ftot[..., 0] + m - m_next)
        wk = w_src[..., None] * kk
        C = decay[..., None, None] * C + wk.transpose(-1, -2) @ vv
        n = decay[..., None] * n + wk.sum(dim=-2)
        m = m_next
    out = ys[:, :, :s].transpose(1, 2).reshape(b, s, d).to(x.dtype)
    return out @ p["wo"], (C, n, m)


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d = cfg.d_model
    return {
        "wz": _dense_init(gen, (d, d), dtype),
        "wi": _dense_init(gen, (d, d), dtype, scale=0.01),
        "wf": _dense_init(gen, (d, d), dtype, scale=0.01),
        "wo_gate": _dense_init(gen, (d, d), dtype, scale=0.01),
        "bf": torch.full((d,), 3.0, dtype=dtype, device=gen.device),
        "wo": _dense_init(gen, (d, d), dtype),
    }


def slstm(x: torch.Tensor, p: Params, cfg: ModelConfig, state: tuple | None = None):
    """Stabilized sLSTM, a sequential scalar recurrence: a loop over time
    carrying (c, n, m), each (B, D) fp32."""
    b, s, d = x.shape
    f32 = torch.float32
    z = torch.tanh(x @ p["wz"]).float()
    i_ = (x @ p["wi"]).float()
    logf = F.logsigmoid((x @ p["wf"] + p["bf"]).float())
    o_ = torch.sigmoid((x @ p["wo_gate"]).float())
    if state is None:
        c = torch.zeros((b, d), dtype=f32, device=x.device)
        n = torch.zeros((b, d), dtype=f32, device=x.device)
        m = torch.full((b, d), -1e30, dtype=f32, device=x.device)
    else:
        c, n, m = state
    ys = torch.empty((b, s, d), dtype=f32, device=x.device)
    for t in range(s):  # 13 launches a step; the output gate is applied after the loop
        it, lfm = i_[:, t], logf[:, t] + m
        m = torch.maximum(lfm, it)
        fg, ig = torch.exp(lfm - m), torch.exp(it - m)
        c = torch.addcmul(fg * c, ig, z[:, t])
        n = torch.addcmul(ig, fg, n)
        ys[:, t] = c / n.abs().clamp_min(1.0)
    return (ys * o_).to(x.dtype) @ p["wo"], (c, n, m)
