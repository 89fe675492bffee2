"""The model's forward pass written out in fp32: the yardstick.

No cache, no batching, no kernels: ``kernels.ref`` for normalisation and
attention and torch matmuls for the rest, every weight upcast to fp32 as it
is used.  It covers every family: dense, moe, vlm (patch embeddings before
the text), audio (encoder, then a decoder with cross-attention), hybrid
(attention and Mamba layers, MoE on some) and ssm (mLSTM and sLSTM layers).
The tests hold it against the reference's ``forward``, and
``chip_smoke.py`` holds the served model against it on the card at full
width.  It applies the sliding window at every position, as the reference's
``forward`` does.

The recurrent mixers share no code with ``layers``: Mamba is the plain
per-position recurrence ``h = exp(dt A) h + dt B x, y = C h`` (the engine's
is a chunked log-step scan, another association); the mLSTM is its
recurrent stabilized form, one position at a time (the engine's is
chunkwise-parallel), the normalizer carried as the memory of a constant 1
value; the sLSTM is the recurrence as written.

An MoE layer computes, per expert, only the tokens routed to it.  Two
optional arguments let it follow how the engine dispatched a sequence:

* ``moe_groups`` — the spans of positions dispatched together, each with the
  number of tokens in that call (padding included), whose capacity it keeps
  (``None``: nothing dropped).  A served request is its prompt,
  ``(0, p_len, bucket)``, then one no-drop span per decoded token.  Default:
  one group of all S tokens, the reference's ``forward``.
* ``routing`` — the engine's experts per MoE layer, in layer order,
  ``(S, top_k)`` each.  Where
  they differ from this forward's own fp32 top-k, the engine's choice is taken
  only if each of its experts' fp32 logit lies within ``ROUTER_MARGIN`` of the
  own k-th largest (a near-tie from bf16 rounding); any other difference
  raises.  Gates always come from this forward's fp32 logits.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ref

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
# above this many score elements per head, attention runs in tiles
CHUNKED_ABOVE = 1 << 22
# How far (in fp32 router logit) an engine-chosen expert may lie below this
# forward's own k-th largest logit and still count as a near-tie.  About twice
# the largest |engine - plain| router logit where the two chose alike: 0.0599
# over four served Mixtral 8x7B requests on an H100 (logits of std ~1; PERF.md),
# where the near-ties taken lay at most 0.0467 below.  bf16 activations move
# the logits that much, so a choice inside the margin is rounding, one
# outside it a fault.
ROUTER_MARGIN = 0.12


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """The reference's slots per expert when ``n_tokens`` tokens are
    dispatched together (``repro/models/layers.py``), written out here so
    that the yardstick shares no code with the engine it checks."""
    c = math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, Dh) at positions 0..S-1."""
    s, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def gates(logits: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Softmax over the chosen experts' logits: (S, E), (S, k) -> (S, k)."""
    return torch.softmax(logits.gather(1, experts), dim=-1)


def _groups(cfg: ModelConfig, s: int, moe_groups):
    """(group of each position (S,), capacity of each group (G,))."""
    if moe_groups is None:
        moe_groups = [(0, s, s)]
    gid = torch.empty(s, dtype=torch.int64)
    caps, at = [], 0
    for i, (a, b, n) in enumerate(moe_groups):
        if a != at or b <= a or (n is not None and n < b - a):
            raise ValueError(f"moe_groups must cover 0..{s} in order: {moe_groups}")
        gid[a:b] = i
        caps.append(b - a if n is None else capacity(cfg, n))  # b - a tokens: no drop
        at = b
    if at != s:
        raise ValueError(f"moe_groups cover 0..{at}, not 0..{s}")
    return gid, torch.tensor(caps)


def _route(logits, chosen, k: int, stats):
    """The experts to use: own fp32 top-k, or the engine's ``chosen`` where it
    differs only by a near-tie."""
    top, own = torch.topk(logits, k, dim=-1)
    if chosen is None:
        return own
    chosen = chosen.to(device=own.device, dtype=torch.int64)
    differ = (own.sort(-1).values != chosen.sort(-1).values).any(-1)
    gap = (top[:, -1:] - logits.gather(1, chosen)).amax(-1)  # how far below own k-th
    bad = differ & (gap > ROUTER_MARGIN)
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise ValueError(f"routing at position {i}: engine chose {chosen[i].tolist()}, fp32 "
                         f"top-{k} is {own[i].tolist()}, {float(gap[i]):.4f} below its k-th "
                         f"logit (margin {ROUTER_MARGIN})")
    if stats is not None and bool(differ.any()):
        stats["near_ties"] = stats.get("near_ties", 0) + int(differ.sum())
        stats["max_tie_gap"] = max(stats.get("max_tie_gap", 0.0), float(gap[differ].max()))
    return torch.where(differ[:, None], chosen, own)


def _moe(cfg: ModelConfig, y, m, gid, caps, chosen, stats, f):
    """fp32 MoE FFN of y (S, D), per expert over the tokens routed to it and
    kept by their group's capacity (first come, in position order)."""
    e, k = cfg.n_experts, cfg.top_k
    logits = y @ f(m["router"])
    experts = _route(logits, chosen, k, stats)
    if stats is not None:
        stats.setdefault("router_logits", []).append(logits)
        stats.setdefault("experts", []).append(experts)
    g = gates(logits, experts).reshape(-1)
    key = (gid.to(y.device)[:, None] * e + experts).reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(int(caps.numel()) * e, dtype=torch.int64, device=y.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel(), device=y.device) - starts[key[order]]
    keep = rank < caps.to(y.device)[key // e]
    out = torch.zeros_like(y)
    flat = experts.reshape(-1)
    for ex in range(e):
        idx = ((flat == ex) & keep).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        tok = idx // k
        xt = y[tok]
        o = (F.silu(xt @ f(m["wg"][ex])) * (xt @ f(m["wu"][ex]))) @ f(m["wd"][ex])
        out.index_add_(0, tok, o * g[idx][:, None])
    return out


def moe_ffn(cfg: ModelConfig, y: torch.Tensor, m: dict, n_tokens: int | None,
            routing=None) -> torch.Tensor:
    """One MoE layer in fp32 on ``y`` (S, D) with the parameters ``m``, its S
    tokens dispatched in one call of ``n_tokens`` tokens (``None``: nothing
    dropped); ``routing`` as in the module docstring, for one layer."""
    s = y.shape[0]
    gid, caps = _groups(cfg, s, [(0, s, n_tokens)])
    return _moe(cfg, y.to(torch.float32), m, gid, caps, routing, None,
                lambda w: w.to(torch.float32))


def _attention(cfg: ModelConfig, a: dict, y: torch.Tensor, f, *, causal: bool,
               memory: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 attention sub-block on ``y`` (S, D): self-attention with rope and
    the window, or cross-attention over ``memory`` (no rope, no mask)."""
    s = y.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = y if memory is None else memory
    bq, bk, bv = (f(a[n]) if n in a else 0.0 for n in ("bq", "bk", "bv"))
    q = (y @ f(a["wq"]) + bq).view(s, h, dh)
    k = (src @ f(a["wk"]) + bk).view(-1, kv, dh)
    v = (src @ f(a["wv"]) + bv).view(-1, kv, dh)
    if memory is None:
        q, k = _rope(q, cfg.rope_theta), _rope(k, cfg.rope_theta)
    attend = ref.attention_chunked if s * k.shape[0] > CHUNKED_ABOVE else ref.attention
    o = attend(q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
               v.transpose(0, 1).contiguous(), causal=causal and memory is None,
               window=cfg.window if memory is None else None)
    return o.transpose(0, 1).reshape(s, h * dh) @ f(a["wo"])


def _ffn(y: torch.Tensor, m: dict, f) -> torch.Tensor:
    return (F.silu(y @ f(m["wg"])) * (y @ f(m["wu"]))) @ f(m["wd"])


# positions whose Mamba transitions are formed at once (a (256, Din, N) block)
MAMBA_BLOCK = 256


def _mamba(cfg: ModelConfig, mx: dict, y: torch.Tensor, f) -> torch.Tensor:
    """fp32 Mamba mixer on ``y`` (S, D): causal depthwise conv, then the
    selective SSM one position at a time."""
    s = y.shape[0]
    din, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    r = max(1, cfg.d_model // 16)
    xz = y @ f(mx["in_proj"])
    xin, z = xz[:, :din], xz[:, din:]
    k, w = cfg.mamba_d_conv, f(mx["conv_w"])
    xp = torch.cat([xin.new_zeros((k - 1, din)), xin])
    u = F.silu(sum(w[j] * xp[j:j + s] for j in range(k)) + f(mx["conv_b"]))
    proj = u @ f(mx["x_proj"])
    dt = F.softplus(proj[:, :r] @ f(mx["dt_proj"]) + f(mx["dt_bias"]))  # (S, Din)
    Bm, Cm = proj[:, r:r + n], proj[:, r + n:]
    A = -torch.exp(f(mx["A_log"]))  # (Din, N)
    h = y.new_zeros((din, n))
    out = y.new_empty((s, din))
    for t0 in range(0, s, MAMBA_BLOCK):
        t1 = min(s, t0 + MAMBA_BLOCK)
        decay = torch.exp(dt[t0:t1, :, None] * A)
        inp = (dt[t0:t1] * u[t0:t1])[:, :, None] * Bm[t0:t1, None, :]
        hs = torch.empty_like(decay)
        for t in range(t1 - t0):
            h = decay[t] * h + inp[t]
            hs[t] = h
        out[t0:t1] = torch.einsum("tdn,tn->td", hs, Cm[t0:t1])
    return ((out + f(mx["Dskip"]) * u) * F.silu(z)) @ f(mx["out_proj"])


def _mlstm(cfg: ModelConfig, mx: dict, y: torch.Tensor, f) -> torch.Tensor:
    """fp32 mLSTM mixer on ``y`` (S, D), recurrent: per head, the stabilizer
    ``m_t = max(logf_t + m_{t-1}, logi_t)`` (from -1e30; on the host in
    float64), then ``C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t -
    m_t) k_t [v_t, 1]``, whose last column is the normalizer, and
    ``h_t = q_t C_t[:, :Dh] / max(|q_t C_t[:, Dh]|, exp(-m_t))``."""
    s, d = y.shape
    h = cfg.n_heads
    dh = d // h
    q = (y @ f(mx["wq"])).view(s, h, dh) / math.sqrt(dh)
    k = (y @ f(mx["wk"])).view(s, h, dh)
    v = (y @ f(mx["wv"])).view(s, h, dh)
    logf = F.logsigmoid(y @ f(mx["wf"]) + f(mx["bf"])).double().cpu().numpy()  # (S, H)
    logi = (y @ f(mx["wi"]) + f(mx["bi"])).double().cpu().numpy()
    m, ms = np.full(h, -1e30), np.empty((s, h))
    fg, ig = np.empty((s, h)), np.empty((s, h))
    for t in range(s):
        m_new = np.maximum(logf[t] + m, logi[t])
        fg[t], ig[t] = np.exp(logf[t] + m - m_new), np.exp(logi[t] - m_new)
        ms[t] = m = m_new
    dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=y.device)  # noqa: E731
    fg, ig, ms = dev(fg)[:, :, None, None], dev(ig), dev(ms)
    kin = (ig[..., None] * k)[..., None]  # (S, H, Dh, 1)
    v1 = torch.cat([v, v.new_ones((s, h, 1))], dim=-1)[:, :, None, :]  # (S, H, 1, Dh + 1)
    mem = y.new_zeros((h, dh, dh + 1))
    read = y.new_empty((s, h, 1, dh + 1))
    for t in range(s):
        mem.mul_(fg[t]).baddbmm_(kin[t], v1[t])
        torch.bmm(q[t, :, None, :], mem, out=read[t])
    read = read[:, :, 0]
    den = torch.maximum(read[..., dh].abs(), torch.exp(-ms))
    return (read[..., :dh] / den[..., None]).reshape(s, d) @ f(mx["wo"])


def _slstm(cfg: ModelConfig, mx: dict, y: torch.Tensor, f) -> torch.Tensor:
    """fp32 sLSTM mixer on ``y`` (S, D): the stabilized recurrence over time."""
    s, d = y.shape
    z = torch.tanh(y @ f(mx["wz"]))
    gi = y @ f(mx["wi"])
    lf = F.logsigmoid(y @ f(mx["wf"]) + f(mx["bf"]))
    o = torch.sigmoid(y @ f(mx["wo_gate"]))
    c, n, m = y.new_zeros(d), y.new_zeros(d), y.new_full((d,), -1e30)
    out = y.new_empty((s, d))
    for t in range(s):
        m_new = torch.maximum(lf[t] + m, gi[t])
        fgt, igt = torch.exp(lf[t] + m - m_new), torch.exp(gi[t] - m_new)
        c = fgt * c + igt * z[t]
        n = fgt * n + igt
        out[t] = o[t] * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
    return out @ f(mx["wo"])


_MIXERS = {"mamba": _mamba, "mlstm": _mlstm, "slstm": _slstm}


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *, embeds=None,
            moe_groups=None, routing=None, stats: dict | None = None) -> torch.Tensor:
    """tokens (S,) -> fp32 logits (S, V) of one sequence.

    ``embeds`` (Sf, D): for ``vlm`` patch embeddings put before the text (their
    logits are dropped; None: text only, as the engine serves it), for
    ``audio`` the frame embeddings the encoder reads.  ``moe_groups`` and
    ``routing`` as in the module docstring.  A ``stats`` dict receives
    ``near_ties`` (positions that took the engine's choice), ``max_tie_gap``
    and, per MoE layer, ``router_logits`` and ``experts``.
    """
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the plain forward covers the "
                                  f"{', '.join(FAMILIES)} families (got {cfg.family!r})")
    f = lambda w: w.to(torch.float32)  # noqa: E731
    x = f(params["embed"][tokens])
    n_front, memory = 0, None
    if cfg.family == "vlm" and embeds is not None:
        n_front = embeds.shape[0]
        x = torch.cat([f(embeds), x])
    elif cfg.family == "audio":
        memory = encode(cfg, params, embeds)
    s = x.shape[0]
    if any(cfg.layer_is_moe(l) for l in range(cfg.n_layers)):
        gid, caps = _groups(cfg, s, moe_groups)
    n_moe = 0
    for l, blk in enumerate(params["decoder" if memory is not None else "layers"]):
        y = ref.rmsnorm(x, f(blk["norm1"]), eps=cfg.norm_eps)
        kind = cfg.layer_kind(l)
        if kind == "attn":
            x = x + _attention(cfg, blk["mixer"], y, f, causal=True)
        else:
            x = x + _MIXERS[kind](cfg, blk["mixer"], y, f)
        if memory is not None:
            y = ref.rmsnorm(x, f(blk["norm_x"]), eps=cfg.norm_eps)
            x = x + _attention(cfg, blk["cross"], y, f, causal=False, memory=memory)
        if not cfg.d_ff:
            continue
        y = ref.rmsnorm(x, f(blk["norm2"]), eps=cfg.norm_eps)
        if cfg.layer_is_moe(l):
            x = x + _moe(cfg, y, blk["ffn"], gid, caps,
                         None if routing is None else routing[n_moe], stats, f)
            n_moe += 1
        else:
            x = x + _ffn(y, blk["ffn"], f)
    x = ref.rmsnorm(x[n_front:], f(params["final_norm"]), eps=cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ f(head)


def layer(cfg: ModelConfig, blk: dict, l: int, x: torch.Tensor) -> torch.Tensor:
    """Decoder layer ``l`` alone in fp32 on the residual stream ``x`` (S, D) of
    one sequence, as ``forward`` applies it: for a layer without MoE and
    without cross-attention."""
    if cfg.layer_is_moe(l) or "cross" in blk:
        raise ValueError(f"layer {l}: MoE and cross-attention layers need forward's context")
    f = lambda w: w.to(torch.float32)  # noqa: E731
    x = f(x)
    y = ref.rmsnorm(x, f(blk["norm1"]), eps=cfg.norm_eps)
    kind = cfg.layer_kind(l)
    x = x + (_attention(cfg, blk["mixer"], y, f, causal=True) if kind == "attn"
             else _MIXERS[kind](cfg, blk["mixer"], y, f))
    if cfg.d_ff:
        x = x + _ffn(ref.rmsnorm(x, f(blk["norm2"]), eps=cfg.norm_eps), blk["ffn"], f)
    return x


def encode(cfg: ModelConfig, params: dict, embeds: torch.Tensor) -> torch.Tensor:
    """The audio encoder in fp32 over frame embeddings (Sf, D): bidirectional,
    rope at 0..Sf-1, then the encoder's final norm."""
    f = lambda w: w.to(torch.float32)  # noqa: E731
    x = f(embeds)
    for blk in params["encoder"]:
        y = ref.rmsnorm(x, f(blk["norm1"]), eps=cfg.norm_eps)
        x = x + _attention(cfg, blk["mixer"], y, f, causal=False)
        x = x + _ffn(ref.rmsnorm(x, f(blk["norm2"]), eps=cfg.norm_eps), blk["ffn"], f)
    return ref.rmsnorm(x, f(params["enc_final_norm"]), eps=cfg.norm_eps)
