"""Gradient compression with error feedback (port of
``repro/optim/compression.py``).

Two codecs for a gradient all-reduce over a thin link, both with error
feedback so compression noise carries into the next step instead of being
lost:

  * bf16 — 2x;
  * int8 — 4x, per-tensor absmax scaling, the rounding error kept as the
    residual the next call adds back.

The trainer does not all-reduce across pods yet (``grad_codec`` over a
``pod_axis`` raises until partitioning is ported); the codecs stand alone.
"""
from __future__ import annotations

from typing import Any

import torch

from .adamw import tree_leaves, tree_map, tree_unflatten

Tree = Any


def compress_grads(grads: Tree, residual: Tree | None, codec: str = "bf16"):
    """Returns (compressed, scales, new_residual)."""
    if codec == "none":
        return grads, None, residual
    if codec == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), None, residual
    if codec == "int8":
        def one(g, r):
            gf = g.float() + (r if r is not None else 0.0)
            scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            return q, scale, gf - q.float() * scale

        leaves = tree_leaves(grads)
        res = tree_leaves(residual) if residual is not None else [None] * len(leaves)
        out = [one(g, r) for g, r in zip(leaves, res)]
        return tuple(tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
    raise ValueError(codec)


def decompress_grads(comp: Tree, scales: Tree | None, codec: str = "bf16") -> Tree:
    if codec == "none":
        return comp
    if codec == "bf16":
        return tree_map(lambda g: g.float(), comp)
    if codec == "int8":
        return tree_map(lambda q, s: q.float() * s, comp, scales)
    raise ValueError(codec)
