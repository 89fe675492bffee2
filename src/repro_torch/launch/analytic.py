"""Analytic per-cell cost model: FLOPs / HBM bytes / collective bytes.

Port of ``repro/launch/analytic.py`` (pure arithmetic over the configs;
copied with the import roots changed).  The roofline terms of
``launch/roofline.py`` come from this model: a compiler's own cost counts
see a scanned layer body once, so they undercount by the trip counts.

Conventions (bf16 activations/weights, fp32 optimizer):
  * train accounts fwd (2NT) + bwd (4NT) + block-remat recompute (2NT);
  * the flash-attention kernel keeps scores on chip -> attention contributes
    FLOPs but no O(S^2) HBM traffic;
  * ring collectives: all-reduce moves 2x payload, AG/RS 1x;
  * TP Megatron pairs: 2 activation all-reduces per layer fwd, 2 in bwd;
  * FSDP: per-layer weight all-gather (fwd + bwd re-gather) + gradient
    reduce-scatter; optimizer state touched once per step.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class MeshInfo:
    chips: int
    dp: int     # data-parallel ways (pod * data)
    tp: int     # model-parallel ways


@dataclass
class CellCost:
    flops: float          # per chip
    hbm_bytes: float      # per chip
    coll_bytes: float     # per chip (ring-adjusted)
    detail: dict


def _matmul_params(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) matmul params per layer-average x n_layers + head."""
    d, dh, h, kv, f = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer_attn = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
    total = active = 0.0
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == "attn":
            total += per_layer_attn
            active += per_layer_attn
        elif kind == "mamba":
            din = cfg.mamba_expand * d
            m = d * 2 * din + din * d + din * (max(1, d // 16) + 2 * cfg.mamba_d_state)
            total += m
            active += m
        elif kind in ("mlstm", "slstm"):
            total += 5 * d * d
            active += 5 * d * d
        if cfg.d_ff:
            ffn = 3 * d * f
            if cfg.layer_is_moe(l):
                total += cfg.n_experts * ffn
                active += cfg.top_k * ffn
            else:
                total += ffn
                active += ffn
    if cfg.is_encdec:
        enc = cfg.enc_layers * (per_layer_attn + 3 * d * f)
        dec_cross = cfg.n_layers * per_layer_attn  # cross-attention blocks
        total += enc + dec_cross
        active += enc + dec_cross
    total += d * cfg.vocab  # lm head (embedding gather is traffic, not flops)
    active += d * cfg.vocab
    return total, active


def _attn_layers(cfg: ModelConfig) -> int:
    n = sum(1 for l in range(cfg.n_layers) if cfg.layer_kind(l) == "attn")
    if cfg.is_encdec:
        n += cfg.enc_layers + cfg.n_layers  # encoder self + decoder cross
    return n


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshInfo) -> CellCost:
    d, dh, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    sq = 1 if decode else S
    T = B * sq                      # tokens this step
    B_loc = max(1, B // mesh.dp)
    T_loc = B_loc * sq
    n_total, n_active = _matmul_params(cfg)

    fb = 8 if train else 2          # fwd(2) + bwd(4) + remat(2)
    mm_flops = fb * n_active * T / mesh.chips

    # attention score/value flops (flash: compute yes, HBM no)
    w_eff = min(cfg.window or S, S)
    if shape.kind != "decode" and cfg.window is None:
        w_eff = S / 2  # causal average
    attn_per_layer = 4 * B * sq * w_eff * h * dh
    attn_flops = (4 if train else 1) * attn_per_layer * _attn_layers(cfg) / mesh.chips
    # ssm scan flops
    ssm_flops = 0.0
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == "mamba":
            din = cfg.mamba_expand * d
            ssm_flops += 10 * B * sq * din * cfg.mamba_d_state
        elif kind == "mlstm":
            q = min(128, sq)
            ssm_flops += 4 * B * sq * (q + 2 * (d // max(1, h))) * d
        elif kind == "slstm":
            ssm_flops += 12 * B * sq * d
    ssm_flops *= (3 if train else 1) / mesh.chips

    flops = mm_flops + attn_flops + ssm_flops

    # ---- HBM bytes per chip -------------------------------------------------
    n_loc_total = n_total / mesh.chips if train else n_total / mesh.tp
    if not train and n_total * 2 / mesh.tp > 16e9:
        n_loc_total = n_total / mesh.chips  # big models: weights fully sharded
    w_bytes = (3 if train else 1) * 2 * n_loc_total  # weight reads (bf16)
    opt_bytes = (20 * n_total / mesh.chips) if train else 0.0  # m,v fp32 r/w + grads
    act_bytes = 0.0
    if sq > 1:
        act_bytes = (3 if train else 1) * 12 * T_loc * d * 2 * cfg.n_layers / mesh.tp
    logits_bytes = 3 * T_loc * cfg.vocab * 2 / mesh.tp
    kv_bytes = 0.0
    if decode:
        cache_w = min(cfg.window or S, S)
        kv_bytes = 2 * B_loc * cache_w * kv * dh * 2 * (
            sum(1 for l in range(cfg.n_layers) if cfg.layer_kind(l) == "attn")
            + (cfg.n_layers if cfg.is_encdec else 0)
        )
    hbm = w_bytes + opt_bytes + act_bytes + logits_bytes + kv_bytes

    # ---- collective bytes per chip (ring-adjusted) ---------------------------
    act = T_loc * d * 2
    tp_layers = cfg.n_layers + (cfg.enc_layers if cfg.is_encdec else 0)
    tp_coll = (3 if train else 1) * 2 * (2 * act) * tp_layers  # 2 AR/layer, 2x ring
    fsdp_coll = 0.0
    dp_coll = 0.0
    if train:
        layer_w = 2 * (n_total - d * cfg.vocab) / max(1, mesh.tp)  # bf16, per dp group
        fsdp_coll = 2 * layer_w  # AG fwd + AG bwd (per chip, (dp-1)/dp ~ 1)
        dp_coll = 2 * layer_w    # grad reduce-scatter + update all-gather
    ep_coll = 0.0
    if cfg.is_moe and sq > 1:
        moe_layers = sum(1 for l in range(cfg.n_layers) if cfg.layer_is_moe(l))
        # dispatch + combine of top_k token copies per MoE layer
        ep_coll = (3 if train else 1) * 2 * cfg.top_k * T_loc * d * 2 * moe_layers
    coll = tp_coll + fsdp_coll + dp_coll + ep_coll

    return CellCost(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll,
        detail=dict(mm=mm_flops, attn=attn_flops, ssm=ssm_flops,
                    w=w_bytes, opt=opt_bytes, act=act_bytes,
                    logits=logits_bytes, kvc=kv_bytes,
                    tp=tp_coll, fsdp=fsdp_coll, dp=dp_coll, ep=ep_coll,
                    n_total=n_total, n_active=n_active),
    )
