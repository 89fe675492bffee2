"""The dense decoder's forward pass written out in fp32: the yardstick.

No cache, no batching, no kernels: ``kernels.ref`` for normalisation and
attention and torch matmuls for the rest, every weight upcast to fp32 as it
is used.  The tests hold it against the reference's ``forward``, and
``chip_smoke.py`` holds the served model against it on the card at full
width.  It applies the sliding window at every position, as the reference's
``forward`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ref

# above this many score elements per head, attention runs in tiles
CHUNKED_ABOVE = 1 << 22


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, Dh) at positions 0..S-1."""
    s, _, dh = x.shape
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(), x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (S,) -> fp32 logits (S, V) of one sequence."""
    if cfg.family != "dense":
        raise NotImplementedError(f"plain forward covers the dense family, not {cfg.family!r}")
    f = lambda w: w.to(torch.float32)  # noqa: E731
    s = tokens.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attend = ref.attention_chunked if s * s > CHUNKED_ABOVE else ref.attention
    x = f(params["embed"][tokens])
    for blk in params["layers"]:
        a, m = blk["mixer"], blk["ffn"]
        y = ref.rmsnorm(x, f(blk["norm1"]), eps=cfg.norm_eps)
        bq, bk, bv = (f(a[n]) if n in a else 0.0 for n in ("bq", "bk", "bv"))
        q = _rope((y @ f(a["wq"]) + bq).view(s, h, dh), cfg.rope_theta)
        k = _rope((y @ f(a["wk"]) + bk).view(s, kv, dh), cfg.rope_theta)
        v = (y @ f(a["wv"]) + bv).view(s, kv, dh)
        o = attend(q.transpose(0, 1).contiguous(), k.transpose(0, 1).contiguous(),
                   v.transpose(0, 1).contiguous(), causal=True, window=cfg.window)
        x = x + o.transpose(0, 1).reshape(s, h * dh) @ f(a["wo"])
        y = ref.rmsnorm(x, f(blk["norm2"]), eps=cfg.norm_eps)
        x = x + (F.silu(y @ f(m["wg"])) * (y @ f(m["wu"]))) @ f(m["wd"])
    x = ref.rmsnorm(x, f(params["final_norm"]), eps=cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ f(head)
