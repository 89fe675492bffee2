"""AdamW and its learning-rate schedules (port of ``repro/optim/adamw.py``).

The reference's formula, not ``torch.optim.AdamW``: the global gradient norm
clips the step, a non-finite norm skips it (the parameters stay as they are,
the moments decay as if the gradient were 0, and the step counter still
advances), all arithmetic is fp32 and each parameter is cast back to its own
type.  The state is a tree shaped like the parameters: ``m`` and ``v`` in
fp32 on the parameters' device, ``step`` a 0-d int32 tensor on the host (the
schedule reads it without waiting for the card).

From JAX to torch: the reference returns new arrays; here ``adamw_update``
writes the parameters and moments in place and returns them, since the
moments of a 2.7 B-parameter model are 21.8 GB.  The schedule is computed in
float32 on the host, as the reference computes it in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

Tree = Any
_CHUNK = 1 << 24  # elements a leaf's update takes at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # 'cosine' | 'wsd' | 'const'
    wsd_decay_frac: float = 0.1  # final fraction of steps in 1-sqrt decay
    min_lr_frac: float = 0.1


def tree_leaves(tree: Tree) -> list:
    """The leaves of a tree of dicts (keys in sorted order, as JAX flattens
    them), lists and tuples, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Tree, leaves: list) -> Tree:
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *r) for t, *r in zip(tree, *rest))
    return fn(tree, *rest)


def lr_at(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (an int or a 0-d tensor), in float32."""
    f = np.float32
    s = f(int(step))
    warm = min(f(1.0), (s + f(1.0)) / f(max(1, cfg.warmup_steps)))
    if cfg.schedule == "const":
        sched = f(1.0)
    elif cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM): stable plateau, then sqrt-like decay
        decay_start = f(cfg.total_steps * (1.0 - cfg.wsd_decay_frac))
        frac = np.clip((s - decay_start) / f(max(1.0, cfg.total_steps - decay_start)),
                       f(0.0), f(1.0))
        sched = f(1.0) - f(1.0 - cfg.min_lr_frac) * np.sqrt(frac)
    else:  # cosine
        frac = np.clip(s / f(max(1, cfg.total_steps)), f(0.0), f(1.0))
        sched = f(cfg.min_lr_frac) + f(1 - cfg.min_lr_frac) * f(0.5) * (
            f(1.0) + np.cos(f(math.pi) * frac))
    return float(f(cfg.lr) * f(warm) * f(sched))


def adamw_init(params: Tree) -> dict:
    """Zero fp32 moments shaped like ``params``, on their devices, and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(grads: Tree, mesh=None, specs: Tree | None = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in fp32 (a 0-d tensor).

    Under a mesh, ``grads`` are this rank's shards cut by ``specs``: the
    norm is the whole model's, and the same on every rank.  A leaf adds its
    squares on the ranks at coordinate 0 along every axis of more than one
    rank that it is not cut over (a replicated leaf: along every axis), and
    one sum over the mesh gives each rank the total.  A rank that adds
    nothing adds its squares times 0, so a non-finite gradient on any rank
    makes the norm non-finite on every rank."""
    leaves = tree_leaves(grads)
    squares = [torch.sum(torch.square(g.float())) for g in leaves]
    axes = [a for a in mesh.axis_names if mesh.shape[a] > 1] if mesh is not None else []
    if not axes:
        return torch.sqrt(sum(squares))
    from ..launch import sharding as SH

    total = torch.zeros((), dtype=torch.float32, device=squares[0].device)
    for sq, spec in zip(squares, SH.leaf_specs(grads, specs)):
        cut = SH.cut_axes(spec, mesh)
        counted = all(mesh.local_rank(a) == 0 for a in axes if a not in cut)
        total = total + (sq if counted else sq * 0.0)
    for a in axes:
        total = SH.all_reduce_sum(total, mesh.get_group(a))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: dict, mesh=None, specs: Tree | None = None) -> tuple[Tree, dict, dict]:
    """One AdamW step: (params, state, metrics), the parameters and moments
    updated in place.  NaN/inf gradients skip the step (fault tolerance: a
    poisoned micro-batch must not corrupt the weights).  ``metrics``:
    ``grad_norm`` (before clipping) and ``skipped`` as 0-d tensors on the
    device, ``lr`` as a float.  Under a mesh the norm that clips and skips
    is the whole model's (``global_norm``), the same on every rank."""
    step = int(state["step"])
    gnorm = global_norm(grads, mesh, specs)
    finite = torch.isfinite(gnorm)
    scale = torch.where(finite & (gnorm > cfg.grad_clip),
                        cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        torch.ones((), device=gnorm.device))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = np.float32(step + 1)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    zero = torch.zeros((), device=gnorm.device)

    def upd(p, g, m, v):
        if p.numel() > _CHUNK and all(t.is_contiguous() for t in (p, g, m, v)):
            # elementwise, so a chunk at a time gives the same bits with a
            # chunk's temporaries live instead of the leaf's (a Mixtral
            # expert tensor's are 0.9 GB each)
            for a in range(0, p.numel(), _CHUNK):
                upd(*(t.view(-1)[a:a + _CHUNK] for t in (p, g, m, v)))
            return
        g = torch.where(finite, g.float() * scale, zero)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        p32 = p.float()
        delta = lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32)
        p.copy_(p32 - torch.where(finite, delta, zero))

    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state["m"], state["v"]))):
        upd(p, g, m, v)
    new_state = {"m": state["m"], "v": state["v"],
                 "step": torch.tensor(step + 1, dtype=torch.int32)}
    return params, new_state, {"grad_norm": gnorm, "lr": lr, "skipped": ~finite}
