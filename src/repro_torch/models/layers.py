"""Model building blocks of the decoder (port of ``repro/models/layers.py:80-249``):
rope, attention (self- and cross-attention), the dense SwiGLU FFN and the MoE
FFN.

Plain functions over dicts of tensors.  Attention goes through
``kernels.ops`` (K5 on the card), the MoE experts through
``ops.grouped_matmul`` (K6), projections stay ``x @ w`` in torch with
the reference's ``(d_in, d_out)`` weight layout, as the reference leaves them
to XLA outside any Pallas kernel.  The reference's ``constrain`` (sharding
hints) has no counterpart: the port runs on one device.

KV caches are laid out ``(B, KV, S, Dh)`` — the reference's is
``(B, S, KV, Dh)`` — so that folding heads into K5's ``(B*KV, S, Dh)`` is a
view and not a copy of the whole cache on every step.  Caches are updated
in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

Params = dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)


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
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    src = x if memory is None else memory
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(b, s, h, dh)
    k = k.view(b, -1, kv, dh)
    v = v.view(b, -1, kv, dh)
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
    return out @ p["wo"]


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": _dense_init(gen, (d, f), dtype),
        "wu": _dense_init(gen, (d, f), dtype),
        "wd": _dense_init(gen, (f, d), dtype),
    }


def dense_ffn(x: torch.Tensor, p: Params) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


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


def moe_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig,
            capacity: int | None = None) -> torch.Tensor:
    """Top-k token-choice MoE with static capacity (sort-based dispatch).

    x (T, D) -> (T, D).  ``capacity`` defaults to ``moe_capacity(cfg, T)``, the
    reference's; assignments over it (capacity overflow) contribute 0.  The
    batched decode passes ``capacity=T``, which drops nothing, as the
    reference's per-slot decode (T = 1, capacity 8) never does.
    """
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe_capacity(cfg, t) if capacity is None else capacity
    gates, experts = moe_route(x, p["router"], k)
    order, dest, keep = moe_dispatch(experts, e, c)
    st = torch.div(order, k, rounding_mode="floor")  # token of each sorted assignment
    sg = gates.reshape(-1)[order]

    disp = x.new_zeros((e * c + 1, d))
    disp.index_copy_(0, dest, x[st])  # kept rows are distinct; overflow rows land on e*c
    disp = disp[: e * c].view(e, c, d)
    h = ops.grouped_matmul(disp, p["wg"])
    u = ops.grouped_matmul(disp, p["wu"])
    y = ops.grouped_matmul(F.silu(h) * u, p["wd"])  # (E, C, D)

    y_flat = torch.cat([y.view(e * c, d), y.new_zeros((1, d))])
    contrib = y_flat[dest] * (sg * keep.to(sg.dtype))[:, None]
    return x.new_zeros((t, d)).index_add_(0, st, contrib)
