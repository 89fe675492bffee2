"""Model assembly (port of ``repro/models/model.py:38-471``).

Ported: ``init_params``, ``forward``, ``encode``, ``init_decode_state`` (ring
and full caches), ``decode_step`` (prefill s > 1 and decode s = 1),
``init_slot_states``, ``write_slot``, ``decode_slots`` and
``decode_slots_greedy``, for all six families of the reference: ``dense``,
``moe``, ``vlm``, ``audio``, ``hybrid`` (Jamba: attention and Mamba layers,
MoE on every second layer) and ``ssm`` (xLSTM: mLSTM and sLSTM layers, no
FFN).  A layer's mixer is ``cfg.layer_kind(l)`` and its FFN is
``layers.moe_ffn`` where ``cfg.layer_is_moe(l)``, ``layers.dense_ffn``
elsewhere, and absent where ``cfg.d_ff == 0``.

Frontends are stubs, as in the reference: ``vlm`` takes precomputed patch
embeddings (``batch["embeds"]``) before the text in ``forward`` and drops
their logits; its decode path is text-only.  ``audio`` encodes precomputed
frame embeddings with a bidirectional encoder (``encode``); each decoder
block adds a cross-attention sub-block over that memory, which a decode
state carries as ``"memory"`` (one per slot on the serving path).

From JAX to torch: the reference's ``lax.scan`` over stacked layers (or over
stacked periods, for ``hybrid`` and ``ssm``) is a loop over a list of
per-layer parameter dicts, so a model of any depth builds, a cut of part of
a period included; its ``vmap`` over serving slots is a slot dimension
written out — per-slot write positions go through advanced indexing into
the caches, per-slot rope positions and K5 offsets come from the per-slot
``len``.  Attention caches are updated in place (a Danube cache of 8 slots x
4096 positions is 3 GB); a recurrent layer's new state replaces its old one
in the state's list.

Remat: under grad, ``forward`` wraps each block in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` when
``cfg.remat == "block"`` (the reference's ``jax.checkpoint`` per block, or
per period for ``hybrid`` and ``ssm``: the same gradients), so the backward
keeps each block's input and recomputes the rest; ``"none"`` keeps
everything.  ``"block_save_moe"`` also keeps an MoE block's dispatch buffer
and expert outputs (``_block_save_moe``).  ``"layer"`` raises.  Without grad
(serving) nothing is wrapped.

MoE capacity: ``forward`` and ``decode_step`` dispatch the ``B * s`` tokens
of a call together with ``moe_capacity(cfg, B * s)``, as the reference does.
The reference decodes slots one by one under ``vmap`` (T = 1, capacity 8:
nothing is ever dropped); ``decode_slots`` dispatches all N slots in one
call with a capacity of N per expert, which drops nothing either.

Under a mesh (``launch.mesh.set_mesh``, the serving engine's and the
trainer's) the
parameters are this rank's shards (``launch.sharding``).  The embedding is
vocab-parallel where its rows are cut (rows outside the rank's range give
0, summed over ``model``: exact) and feature-parallel where its columns are
(gathered over ``model``).  The logits come back vocab-local where the head
is cut on the vocabulary (``lm_head``, or a tied vocab-parallel
``embed``), whole where a tied feature-parallel ``embed`` makes the head
row-parallel; ``full_vocab`` gathers them and ``decode_slots_greedy``
takes a distributed argmax.  Caches hold this rank's KV heads
(``sharding.attention_heads``) and ``init_slot_states`` only this rank's
slots (``sharding.slot_layout``).  ``forward`` (the training path, under
the trainer's mesh) embeds through the same ``_embed``, whose collectives
are differentiable, takes this rank's rows of a batch split over the
data-parallel axes, and refuses ``cfg.seq_parallel`` (ROADMAP queue 1,
item 6, step 3b); remat's recompute re-enters the mesh (``_in_mesh``).

State layout: ``{"len": int, "layers": ...}``; slot states have ``"len"`` as
an int32 tensor of one length per slot and B = the slot count.

* ``dense``, ``moe``, ``vlm``, ``audio``: ``"layers"`` is ``(K, V)``, each
  ``(n_layers, B, KV, S_cache, Dh)``, plus ``"memory"`` ``(B, frontend_len,
  d_model)`` for ``audio``;
* ``hybrid``, ``ssm``: ``"layers"`` is a list with one state per layer, of
  its kind: attention ``(K, V)`` each ``(B, KV, S_cache, Dh)``; Mamba
  ``(conv_buf (B, d_conv - 1, Din), h (B, Din, N) fp32)``; mLSTM ``(C (B, H,
  Dh, Dh), n (B, H, Dh), m (B, H))`` and sLSTM ``(c, n, m)`` each ``(B, D)``,
  all fp32.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.flash_attention import expand_offsets
from ..launch import sharding as SH
from ..launch.mesh import current_mesh, set_mesh
from . import layers as L

Params = dict[str, Any]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
# families whose layers carry token-recurrent state (one state per layer)
RECURRENT_FAMILIES = ("hybrid", "ssm")


def layer_period(cfg: ModelConfig) -> int | None:
    """Layers a period of a ``hybrid`` or ``ssm`` model, the length of the
    reference's ``periods`` (``repro/models/model.py:96-114``); None for the
    families the reference stacks as ``layers``."""
    if cfg.family == "hybrid":
        return cfg.attn_period
    if cfg.family == "ssm":
        return len(cfg.block_pattern)
    return None


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {' and '.join(PORTED_FAMILIES)} families only "
            f"so far (got {cfg.family!r})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on ``gen.device``, drawn like the reference's
    ``init_params`` (same shapes and scales; other numbers)."""
    check_family(cfg)
    dt, dev = dtype_of(cfg), gen.device
    p: Params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev)
                  * 0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen, device=dev)
                        / math.sqrt(cfg.d_model)).to(dt)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=dev)  # noqa: E731

    def block(l: int) -> Params:
        p = {"norm1": ones(), "mixer": _MIXER_INIT[cfg.layer_kind(l)](gen, cfg, dt)}
        if cfg.d_ff:
            p["norm2"] = ones()
            p["ffn"] = (L.init_moe_ffn(gen, cfg, dt) if cfg.layer_is_moe(l)
                        else L.init_dense_ffn(gen, cfg, dt))
        return p

    if cfg.family == "audio":
        p["encoder"] = [block(l) for l in range(cfg.enc_layers)]
        p["decoder"] = [dict(block(l), norm_x=ones(), cross=L.init_attention(gen, cfg, dt))
                        for l in range(cfg.n_layers)]
        p["enc_final_norm"] = ones()
    else:
        p["layers"] = [block(l) for l in range(cfg.n_layers)]
    return p


_MIXER_INIT = {"attn": L.init_attention, "mamba": L.init_mamba, "mlstm": L.init_mlstm,
               "slstm": L.init_slstm}
_RECURRENT_MIXERS = {"mamba": L.mamba, "mlstm": L.mlstm, "slstm": L.slstm}


def decoder_layers(cfg: ModelConfig, params: Params) -> list[Params]:
    """The blocks the tokens run through: ``decoder`` for audio, else ``layers``."""
    return params["decoder"] if cfg.family == "audio" else params["layers"]


# ---------------------------------------------------------------------------
# blocks, forward
# ---------------------------------------------------------------------------
def _mixer(x, blk: Params, cfg: ModelConfig, l: int, positions, state=None, write_pos=0,
           attn_offset=0, causal=True, memory=None):
    """Layer ``l``'s first half: the mixer (and an audio decoder's
    cross-attention) with its residual; (x, the layer's state after it)."""
    normed = ops.rmsnorm(x, blk["norm1"], eps=cfg.norm_eps)
    kind = cfg.layer_kind(l)
    if kind == "attn":
        x = x + L.attention(normed, blk["mixer"], cfg, positions=positions, causal=causal,
                            cache=state, write_pos=write_pos, attn_offset=attn_offset)
        if memory is not None:  # cross-attention sub-block (enc-dec decoder)
            normed_x = ops.rmsnorm(x, blk["norm_x"], eps=cfg.norm_eps)
            x = x + L.attention(normed_x, blk["cross"], cfg, positions=positions, causal=False,
                                memory=memory)
    else:
        out, state = _RECURRENT_MIXERS[kind](normed, blk["mixer"], cfg, state=state)
        x = x + out
    return x, state


def _apply_block(x, blk: Params, cfg: ModelConfig, l: int, positions, state=None,
                 write_pos=0, attn_offset=0, moe_capacity=None, causal=True, memory=None):
    """Layer ``l``: (x, the layer's state after it).  An attention layer
    writes its cache ``state`` in place and returns it; a recurrent layer
    returns its new state."""
    x, state = _mixer(x, blk, cfg, l, positions, state=state, write_pos=write_pos,
                      attn_offset=attn_offset, causal=causal, memory=memory)
    if cfg.d_ff:
        normed2 = ops.rmsnorm(x, blk["norm2"], eps=cfg.norm_eps)
        if cfg.layer_is_moe(l):
            b, s, d = normed2.shape
            y = L.moe_ffn(normed2.reshape(b * s, d), blk["ffn"], cfg,
                          capacity=moe_capacity).view(b, s, d)
        else:
            y = L.dense_ffn(normed2, blk["ffn"], cfg)
        x = x + y
    return x, state


def _moe_dispatched(x, blk: Params, cfg: ModelConfig, l: int, positions, memory):
    """An MoE block up to its dispatch buffer: (x after the mixer, the
    buffer, the route's tensors)."""
    x, _ = _mixer(x, blk, cfg, l, positions, memory=memory)
    b, s, d = x.shape
    normed2 = ops.rmsnorm(x, blk["norm2"], eps=cfg.norm_eps)
    disp, route = L.moe_route_dispatch(normed2.reshape(b * s, d), blk["ffn"], cfg)
    return (x, disp, *route)


def _moe_combined(x, y, *route):
    b, s, d = x.shape
    return x + L.moe_combine(y, route, b * s).view(b, s, d)


def _block_save_moe(x, blk: Params, cfg: ModelConfig, l: int, positions, memory, mesh=None):
    """``remat="block_save_moe"`` on an MoE block: three checkpoints split at
    the dispatch buffer and the experts' outputs, so the backward keeps those
    two tensors (the reference's ``save_only_these_names("moe_dispatch",
    "moe_expert_out")``) and recomputes the rest.  The same operations on the
    same values as ``"block"``; every tensor that crosses a split takes at
    most two gradient contributions, whose sum does not depend on their
    order, so the gradients are bit-identical to ``"block"``'s."""
    x, disp, *route = checkpoint(_in_mesh(_moe_dispatched, mesh), x, blk, cfg, l, positions,
                                 memory, use_reentrant=False)
    y = checkpoint(_in_mesh(L.moe_experts, mesh), disp, blk["ffn"], cfg, use_reentrant=False)
    return checkpoint(_in_mesh(_moe_combined, mesh), x, y, *route, use_reentrant=False)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The logits: vocab-local where the head is cut on the vocabulary."""
    x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if L._split(head.shape[-1], cfg.vocab, "the head's vocabulary"):  # column-parallel
        x = L._column(x)
    return L._mm(x, head, cfg.d_model)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``, whole on every rank.  The gather
    is indexing's (``F.embedding``), whose backward sums each row's
    gradients in fp32 in a fixed order, where indexing's sums them in the
    parameters' type with atomics (6.4e-2 relative L2 on MiniCPM-2B's bf16
    embedding gradient against fp32, PERF.md)."""
    e = params["embed"]
    _, r, group = L._tp()
    if L._split(e.shape[1], cfg.d_model, "embed's features"):  # feature-parallel
        return SH.all_gather_cat(F.embedding(tokens, e), group)
    if not L._split(e.shape[0], cfg.vocab, "embed's rows"):
        return F.embedding(tokens, e)
    lo = r * e.shape[0]  # vocab-parallel: rows outside [lo, lo + V/m) give 0
    local = tokens - lo
    mine = (local >= 0) & (local < e.shape[0])
    x = F.embedding(local.clamp(0, e.shape[0] - 1), e)
    return SH.all_reduce_sum(torch.where(mine[..., None], x, torch.zeros_like(x)), group)


def full_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary (gathered over ``model`` where they
    are vocab-local)."""
    if not L._split(logits.shape[-1], cfg.vocab, "logits"):
        return logits
    return SH.all_gather_cat(logits, L._tp()[2])


def forward(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: tokens (B, S) [+ 'embeds' (B, Sf, D) for the vlm/audio
    frontends] -> logits (B, S, V) of the text positions.

    Under a mesh (the trainer's): the parameters are this rank's shards,
    the batch is this rank's rows of a batch split over the mesh's
    data-parallel axes in rank order (the MoE layers route the whole
    batch, ``layers.global_batch``), and the logits are vocab-local where
    the head is cut on the vocabulary.  ``cfg.seq_parallel`` raises."""
    check_family(cfg)
    if cfg.seq_parallel:
        raise NotImplementedError(f"{cfg.name}: seq_parallel (Megatron sequence parallelism "
                                  "between the blocks) is not ported yet (ROADMAP queue 1, "
                                  "item 6, step 3b)")
    mesh = current_mesh()
    with L.global_batch(mesh is not None):
        return _forward(cfg, params, batch, mesh)


def _forward(cfg: ModelConfig, params: Params, batch: dict, mesh) -> torch.Tensor:
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed(cfg, params, tokens)
    n_front, memory = 0, None
    if cfg.frontend is not None and cfg.family == "vlm":
        emb = batch["embeds"].to(x.dtype)  # precomputed patch embeddings
        n_front = emb.shape[1]
        x = torch.cat([emb, x], dim=1)
    elif cfg.family == "audio":
        memory = encode(cfg, params, batch["embeds"])
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :].expand(b, -1)
    for l, blk in enumerate(decoder_layers(cfg, params)):
        if not _remat(cfg, x, blk, memory):
            x, _ = _apply_block(x, blk, cfg, l, positions, memory=memory)
        elif cfg.remat == "block_save_moe" and cfg.layer_is_moe(l):
            x = _block_save_moe(x, blk, cfg, l, positions, memory, mesh)
        else:
            x, _ = checkpoint(_in_mesh(_apply_block, mesh), x, blk, cfg, l, positions,
                              memory=memory, use_reentrant=False)
    logits = _logits(cfg, params, x)
    return logits[:, n_front:] if n_front else logits


def _in_mesh(fn, mesh):
    """``fn`` run under ``mesh`` and ``forward``'s global batch: remat's
    recompute runs in the backward, on autograd's thread for the card,
    where the caller's ``set_mesh`` is not in effect.  ``fn`` itself
    without a mesh."""
    if mesh is None:
        return fn

    def run(*args, **kw):
        with set_mesh(mesh), L.global_batch():
            return fn(*args, **kw)
    return run


def _remat(cfg: ModelConfig, x, blk: Params, memory) -> bool:
    """Whether ``forward`` checkpoints this block: ``cfg.remat`` is
    ``"block"`` or ``"block_save_moe"`` and autograd will differentiate it."""
    if cfg.remat not in ("block", "block_save_moe", "none"):
        raise NotImplementedError(f"{cfg.name}: remat {cfg.remat!r} is not ported (the "
                                  "reference's per-position remat of a period)")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return False
    leaves = [x, memory] + [t for v in blk.values()
                            for t in (v.values() if isinstance(v, dict) else (v,))]
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in leaves)


def encode(cfg: ModelConfig, params: Params, embeds: torch.Tensor) -> torch.Tensor:
    """Audio encoder over precomputed frame embeddings (B, Sf, D), taken in
    the model's dtype: bidirectional (K5 non-causal), rope at 0..Sf-1."""
    check_family(cfg)
    b, sf, _ = embeds.shape
    x = embeds.to(dtype_of(cfg))
    positions = torch.arange(sf, dtype=torch.int32, device=x.device)[None, :].expand(b, sf)
    for l, blk in enumerate(params["encoder"]):
        x, _ = _apply_block(x, blk, cfg, l, positions, causal=False)
    return ops.rmsnorm(x, params["enc_final_norm"], eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _cache_len(cfg: ModelConfig, s_max: int, ring: bool) -> int:
    # SWA archs only ever attend to the last `window` positions: ring=True
    # makes the cache a window-sized ring; ring=False allocates s_max
    return min(s_max, cfg.window) if (ring and cfg.window) else s_max


def _empty_state(cfg: ModelConfig, kind: str, b: int, s_cache: int, device) -> tuple:
    """One layer's fresh decode state (``repro/models/model.py:296-323``)."""
    d, f32 = cfg.d_model, torch.float32
    zeros = lambda shape, dt=f32: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kind == "attn":
        shape = (b, _kv_heads(cfg), s_cache, cfg.head_dim)
        return (zeros(shape, dtype_of(cfg)), zeros(shape, dtype_of(cfg)))
    if kind == "mamba":
        din = cfg.mamba_expand * d
        return (zeros((b, cfg.mamba_d_conv - 1, din), dtype_of(cfg)),
                zeros((b, din, cfg.mamba_d_state)))
    if kind == "mlstm":
        h = cfg.n_heads
        dh = d // h
        return (zeros((b, h, dh, dh)), zeros((b, h, dh)),
                torch.full((b, h), -1e30, dtype=f32, device=device))
    if kind == "slstm":
        return (zeros((b, d)), zeros((b, d)), torch.full((b, d), -1e30, dtype=f32, device=device))
    raise ValueError(kind)


def _kv_heads(cfg: ModelConfig) -> int:
    """KV heads a cache holds on this rank."""
    return len(SH.attention_heads(cfg, current_mesh())[1])


def init_decode_state(cfg: ModelConfig, b: int, s_max: int, ring: bool = True,
                      device: str | torch.device = "cuda") -> dict:
    check_family(cfg)
    dt = dtype_of(cfg)
    s_cache = _cache_len(cfg, s_max, ring)
    if cfg.family in RECURRENT_FAMILIES:
        return {"len": 0, "layers": [_empty_state(cfg, cfg.layer_kind(l), b, s_cache, device)
                                     for l in range(cfg.n_layers)]}
    shape = (cfg.n_layers, b, _kv_heads(cfg), s_cache, cfg.head_dim)
    state = {"len": 0,
             "layers": (torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device))}
    if cfg.family == "audio":
        state["memory"] = torch.zeros((b, cfg.frontend_len, cfg.d_model), dtype=dt,
                                      device=device)
    return state


def _cache_rows(cfg: ModelConfig, state: dict) -> int:
    """Positions an attention cache of ``state`` holds (0: no attention layer)."""
    if cfg.family in RECURRENT_FAMILIES:
        return next((st[0].shape[2] for l, st in enumerate(state["layers"])
                     if cfg.layer_kind(l) == "attn"), 0)
    return state["layers"][0].shape[3]


def _slots(cfg: ModelConfig, clen, s_cache: int):
    """(write position, K5 q_offset) of a step at cache length ``clen`` (an int,
    or a tensor of one length per slot).  A window-sized cache is a ring:
    the write wraps, and the offset caps the causal test so slots not yet
    written stay masked."""
    if cfg.window is not None and s_cache <= cfg.window:
        if isinstance(clen, torch.Tensor):
            return torch.remainder(clen, s_cache), torch.clamp(clen, max=s_cache - 1)
        return clen % s_cache, min(clen, s_cache - 1)
    return clen, clen


def _run_layers(cfg, params, state, x, positions, wpos, aoff, moe_capacity=None):
    kw = dict(write_pos=wpos, attn_offset=aoff, moe_capacity=moe_capacity)
    if cfg.family in RECURRENT_FAMILIES:
        layers = state["layers"]
        for l, blk in enumerate(params["layers"]):
            x, layers[l] = _apply_block(x, blk, cfg, l, positions, state=layers[l], **kw)
        return _logits(cfg, params, x)
    ks, vs = state["layers"]
    memory = state.get("memory")  # audio: (B, frontend_len, D), one per batch row
    for l, blk in enumerate(decoder_layers(cfg, params)):
        x, _ = _apply_block(x, blk, cfg, l, positions, state=(ks[l], vs[l]), memory=memory,
                            **kw)
    return _logits(cfg, params, x)


def decode_step(cfg: ModelConfig, params: Params, state: dict, tokens: torch.Tensor):
    """Decode/prefill step: tokens (B, s) -> (logits (B, s, V), state).

    s == 1 is a decode step; s > 1 prefills the cache (which must be a full
    cache, not a ring) or, for a recurrent layer, runs its scan on from the
    state.  ``state`` is updated in place and returned.
    """
    check_family(cfg)
    b, s = tokens.shape
    clen = int(state["len"])
    x = _embed(cfg, params, tokens)
    positions = (clen + torch.arange(s, dtype=torch.int32, device=x.device))[None, :].expand(b, s)
    wpos, aoff = _slots(cfg, clen, _cache_rows(cfg, state))
    logits = _run_layers(cfg, params, state, x, positions, wpos, aoff)
    state["len"] = clen + s
    return logits, state


# ---------------------------------------------------------------------------
# slot-batched decode (the continuous-batching serve path)
# ---------------------------------------------------------------------------
def init_slot_states(cfg: ModelConfig, n_slots: int, s_max: int,
                     device: str | torch.device = "cuda") -> dict:
    """Decode states for ``n_slots`` independent request slots: full caches
    with the slot as the batch dimension and one length per slot.  Under a
    mesh whose DP axes divide ``n_slots``, this rank's slots only."""
    n_slots = SH.slot_layout(n_slots, current_mesh())[0]
    st = init_decode_state(cfg, n_slots, s_max, ring=False, device=device)
    st["len"] = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return st


def write_slot(states: dict, i: int, state: dict) -> dict:
    """Copy a single-request (b=1) decode state into slot ``i`` (a refill:
    the new request's prefilled caches or recurrent states, length and audio
    memory replace what the finished request left behind).  In place;
    returns ``states``."""
    if isinstance(states["layers"], list):  # one state per layer, batch first
        for dst, src in zip(states["layers"], state["layers"]):
            for d, t in zip(dst, src):
                d[i] = t[0]
    else:  # (K, V) stacked over layers
        for dst, src in zip(states["layers"], state["layers"]):
            dst[:, i] = src[:, 0]
    if "memory" in states:
        states["memory"][i] = state["memory"][0]
    states["len"][i] = int(state["len"])
    return states


def decode_slots(cfg: ModelConfig, params: Params, states: dict, tokens: torch.Tensor):
    """One decode step for every slot at once: tokens (N,) -> (logits (N, V),
    states).  Each slot advances at its own length: rope positions, cache
    write rows and K5 offsets are per slot, an audio slot attends to its own
    memory, and a recurrent layer steps each slot's own state.  MoE layers
    dispatch the N slots together with N slots per expert: nothing is
    dropped."""
    check_family(cfg)
    clen = states["len"]
    x = _embed(cfg, params, tokens)[:, None, :]  # (N, 1, D)
    wpos, aoff = _slots(cfg, clen, _cache_rows(cfg, states))
    # one K5 offset per q row (slot x this rank's heads), expanded once for every layer
    heads = len(SH.attention_heads(cfg, current_mesh())[0])
    aoff = expand_offsets(aoff, x.shape[0] * heads, x.device)
    logits = _run_layers(cfg, params, states, x, clen[:, None], wpos, aoff,
                         moe_capacity=x.shape[0])
    states["len"] = clen + 1
    return logits[:, 0], states


def decode_slots_greedy(cfg: ModelConfig, params: Params, states: dict, tokens: torch.Tensor):
    """``decode_slots`` with the greedy sample taken on the device: returns
    ((N,) int32 next tokens, states), so the engine can feed them to the next
    step without waiting for them."""
    logits, states = decode_slots(cfg, params, states, tokens)
    if not L._split(logits.shape[-1], cfg.vocab, "logits"):
        return torch.argmax(logits, dim=-1).to(torch.int32), states
    _, r, group = L._tp()
    return SH.argmax_sharded(logits, group, r * logits.shape[-1]).to(torch.int32), states
