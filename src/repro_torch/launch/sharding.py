"""The sharding planner and the model stack's collectives (port of
``repro/launch/sharding.py``).

The rules are the reference's, copied: Megatron-style tensor parallelism
(TP) pairs, expert parallelism (EP) for divisible expert counts, data
parallelism (DP) over the batch and sequence parallelism (SP) for the
batch-1 long-context cells, each divisibility-checked against the mesh: a
dimension that does not divide falls back to replication.

  column-parallel (wq/wg/wu/in_proj/...):  (..., D, F) -> (..., None, model)
  row-parallel    (wo/wd/out_proj/...):    (..., F, D) -> (..., model, None)
  expert weights  (E, D, F): EP (model, None, None) when E%model==0,
                             else TP on the trailing dims
  embed (V, D): vocab-parallel when V%model==0 else feature-parallel
  batch dims: (pod, data); KV caches: batch -> DP, heads -> model when
              divisible; batch=1 decode shards the cache *sequence* (SP)

A spec is a :class:`PartitionSpec`: a tuple with one entry per dimension,
None or an axis name or a tuple of axis names.  The rules read only
``mesh.shape`` and ``mesh.axis_names``.

The port keeps one dict of parameters per layer where the reference stacks
the layers on a leading axis.  ``param_specs`` applies the rules to the
per-layer leaves, so a dense FFN's ``(D, F)`` weights are column- and
row-parallel as the module's rules state; the reference applies them to the
stacked ``(L, D, F)`` leaf, which its expert rule takes for ``(E, D, F)``
and shards over the layers (ROADMAP §3).  FSDP's extra dimension is chosen
as on the stacked leaf, whose stack dimension it never takes.
``state_specs`` states the reference's decode-state rule on the port's
layout: attention caches ``(L, B, KV, S, Dh)`` (one ``(B, KV, S, Dh)`` per
layer for ``hybrid`` and ``ssm``) where the reference's are ``(L, B, S, KV,
Dh)``.

``shard_params`` is the counterpart of ``jax.device_put(params, specs)``:
it cuts a full tree to this rank's local tree, and ``gather_params`` is its
inverse.  The collectives the sharded model runs (``all_reduce_sum``,
``all_gather_cat``, ``argmax_sharded``) count their calls and bytes in
``COLLECTIVES``; a row-parallel partial sum is up-cast to fp32, reduced and
rounded once.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .mesh import dp_axes

Pytree = Any


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a tuple
    of axis names the dimension is split over (outermost first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _msize(mesh) -> int:
    # a mesh without a model axis (e.g. the pure-DP column mesh of the
    # sharded canonical-program path) has TP size 0: every divisibility
    # check fails and all rules fall back to replication instead of
    # emitting specs that name a nonexistent axis
    return mesh.shape.get("model", 0)


def _dpsize(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in dp_axes(mesh)]))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
_COLUMN = ("wq", "wk", "wv", "wg", "wu", "in_proj", "dt_proj", "wz", "wi",
           "wf", "wo_gate", "conv_w")
_ROW = ("wo", "wd", "out_proj", "x_proj")


def _param_rule(path: str, shape: tuple[int, ...], mesh, cfg=None) -> P:
    m = _msize(mesh)
    nd = len(shape)
    leaf = path.split("/")[-1].strip("'[]")

    def pad(spec: list) -> P:
        return P(*([None] * (nd - len(spec)) + spec))

    # GQA: a head-count that does not divide the model axis cannot keep its
    # heads sharded.  Shard the *contracting* dim instead (row-parallel:
    # summed over model, output replicated over model).
    if cfg is not None and leaf in ("wq", "wk", "wv") and nd >= 2 and m > 0:
        heads = cfg.n_heads if leaf == "wq" else cfg.n_kv_heads
        if heads % m != 0:
            return pad(["model" if _div(shape[-2], m) else None, None])

    if leaf == "embed":
        if _div(shape[0], m):
            return P("model", None)
        return P(None, "model" if _div(shape[1], m) else None)
    if leaf == "lm_head":
        return P(None, "model" if _div(shape[1], m) else None)
    # MoE expert tensors: (..., E, D, F) with E the -3rd dim
    if "ffn" in path and leaf in ("wg", "wu", "wd") and nd >= 3:
        e = shape[-3]
        if _div(e, m):
            return pad(["model", None, None])  # EP
        if leaf in ("wg", "wu"):
            return pad([None, None, "model" if _div(shape[-1], m) else None])
        return pad([None, "model" if _div(shape[-2], m) else None, None])
    if leaf == "router":
        return P(*([None] * nd))
    if leaf in _COLUMN and nd >= 2:
        return pad([None, "model" if _div(shape[-1], m) else None])
    if leaf in _ROW and nd >= 2:
        return pad(["model" if _div(shape[-2], m) else None, None])
    if leaf in ("bq", "bk", "bv") and nd >= 1:
        return pad(["model" if _div(shape[-1], m) else None])
    if leaf in ("A_log", "Dskip", "conv_b", "dt_bias"):
        # mamba per-channel tensors: shard d_inner (first trailing dim)
        if nd >= 2:
            return pad(["model" if _div(shape[-2], m) else None, None])
        return pad(["model" if _div(shape[-1], m) else None])
    return P(*([None] * nd))  # norms, biases, scalars


def _add_fsdp(spec: P, shape: tuple[int, ...], mesh, exclude_last: bool = False) -> P:
    """Shard one more dim over the DP axes (ZeRO-3/FSDP): parameters and
    optimizer state then scale 1/(dp*model) per rank."""
    dp = dp_axes(mesh)
    dpn = _dpsize(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # candidate dims: largest first; skip already-sharded; skip the leading
    # stack dim of stacked layers
    cands = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in cands:
        if entries[d] is not None:
            continue
        if d == 0 and len(shape) >= 3:
            continue
        if exclude_last and d == len(shape) - 1:
            continue
        if _div(shape[d], dpn) and shape[d] >= dpn:
            entries[d] = dp if len(dp) > 1 else dp[0]
            break
    return P(*entries)


def _walk(tree, fn, path=(), in_layers=False):
    """``fn(path, leaf, in_layers)`` over a tree of dicts and lists, the
    same structure back; ``in_layers``: the leaf lies in a list of layers."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),), in_layers) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, path + (str(i),), True) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn("/".join(path), tree, in_layers)


def param_specs(params: Pytree, mesh, fsdp: bool = False, cfg=None) -> Pytree:
    """A spec for every leaf of a port parameter tree (paths joined by "/",
    e.g. ``layers/3/mixer/wq``)."""

    def spec_of(path, leaf, stacked):
        shape = tuple(leaf.shape)
        leafname = path.split("/")[-1]
        spec = _param_rule(path, shape, mesh, cfg)
        # FSDP as on the reference's stacked leaf: one more (stack) dim
        nd = len(shape) + stacked
        if fsdp and nd >= 2:
            lead = (1,) if stacked else ()
            full = _add_fsdp(P(*((None,) * stacked + tuple(spec))), lead + shape, mesh,
                             exclude_last=leafname in ("wq", "wk", "wv"))
            spec = P(*full[stacked:])
        return spec

    return _walk(params, lambda p, l, s: spec_of(p, l, int(s)))


# ---------------------------------------------------------------------------
# batch / state specs
# ---------------------------------------------------------------------------
def batch_specs(cfg, shape, mesh, batch_shape: Pytree,
                axes: tuple[str, ...] | None = None) -> Pytree:
    """The leading (batch) dim over the DP axes where it divides them."""
    dp = axes if axes is not None else dp_axes(mesh)
    dpn = int(np.prod([mesh.shape[a] for a in dp]))

    def spec_of(path, leaf, _):
        nd = len(leaf.shape)
        b = leaf.shape[0] if nd else 0
        first = dp if _div(b, dpn) else None
        return P(first, *([None] * (nd - 1)))

    return _walk(batch_shape, spec_of)


def _state_rule(path: str, shape: tuple[int, ...], mesh) -> P:
    """The reference's decode-state rule on the reference's layout."""
    dp = dp_axes(mesh)
    dpn = _dpsize(mesh)
    m = _msize(mesh)
    nd = len(shape)
    if nd == 0:
        return P()
    if "memory" in path and nd == 3:  # (B, S_mem, D)
        return P(dp if _div(shape[0], dpn) else None, None,
                 "model" if _div(shape[2], m) else None)
    # KV caches: (L, B, S, KV, dh) or recurrent states (L, B, ...)
    if nd >= 3:
        b = shape[1]
        spec = [None] * nd
        if _div(b, dpn):
            spec[1] = dp
            # shard a feature dim over model when possible
            for d in range(2, nd):
                if d != 2 and _div(shape[d], m):
                    spec[d] = "model"
                    break
        elif nd >= 4:
            # SP: batch too small -> shard the sequence dim of the cache
            if _div(shape[2], dpn):
                spec[2] = dp
            for d in range(3, nd):
                if _div(shape[d], m):
                    spec[d] = "model"
                    break
        return P(*spec)
    return P(*([None] * nd))


_KV_SWAP = (0, 1, 3, 2, 4)  # (L, B, KV, S, Dh) <-> (L, B, S, KV, Dh)


def state_specs(cfg, mesh, state_shape: Pytree) -> Pytree:
    """Decode-state sharding: batch -> DP; KV heads -> model if divisible;
    batch=1 (long-context): the cache's sequence over DP instead (SP).

    The port's attention caches are ``(L, B, KV, S, Dh)``, and one ``(B,
    KV, S, Dh)`` per layer for ``hybrid`` and ``ssm``; a recurrent layer's
    state is batch first.  Each leaf takes the reference's rule on the
    reference's layout (``(L, B, S, KV, Dh)``, a per-layer leaf as a stack
    of one), mapped back."""

    per_layer = cfg.family in ("hybrid", "ssm")

    def spec_of(path, leaf, _):
        if not hasattr(leaf, "shape"):
            return P()  # a python int length
        shape = tuple(leaf.shape)
        parts = path.split("/")
        if parts[0] != "layers":
            return _state_rule(path, shape, mesh)
        full = (1,) + shape if per_layer else shape
        if not per_layer or cfg.layer_kind(int(parts[1])) == "attn":
            spec = _state_rule(path, tuple(full[i] for i in _KV_SWAP), mesh)
            spec = tuple(spec[i] for i in _KV_SWAP)
        else:
            spec = tuple(_state_rule(path, full, mesh))
        return P(*spec[len(full) - len(shape):])

    return _walk(state_shape, spec_of)


def replicated(mesh, tree_shape: Pytree) -> Pytree:
    return _walk(tree_shape, lambda p, l, s: P(*([None] * len(l.shape))))


# ---------------------------------------------------------------------------
# placement: cut a full tree to this rank's shards, and back
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh, entry) -> tuple[int, int]:
    """(shards, this rank's shard) of a dim split over ``entry``'s axes,
    the first axis outermost."""
    n, i = 1, 0
    for a in _entry_axes(entry):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.local_rank(a)
    return n, i


def _local(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    out = t
    for d, entry in enumerate(spec):
        n, i = shard_index(mesh, entry)
        if n > 1:
            k = t.shape[d] // n
            out = out.narrow(d, i * k, k)
    if out is t:
        return t.to(mesh.device)
    if out.device == mesh.device:  # a copy of the shard, so the full leaf can go
        return out.clone(memory_format=torch.contiguous_format)
    return out.to(mesh.device).contiguous()


def shard_params(params: Pytree, specs: Pytree, mesh) -> Pytree:
    """Cut a full parameter tree to this rank's local tree (on
    ``mesh.device``), like ``jax.device_put(params, specs)``.

    The tree is cut in place, one leaf at a time: each full leaf is
    replaced by this rank's shard, so a leaf that nothing else holds is
    freed before the next is cut.  A caller that keeps the full tree passes
    a copy of its containers (``copy_tree``).  Returns the tree."""

    def cut(tree, spec_tree):
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            v, s = tree[k], spec_tree[k]
            if isinstance(v, (dict, list)):
                cut(v, s)
            else:
                tree[k] = None  # drop the full leaf before the shard exists beside it
                tree[k] = _local(v, s, mesh)
                del v

    cut(params, specs)
    return params


def copy_tree(tree: Pytree) -> Pytree:
    """New dicts and lists over the same leaves."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v) for v in tree]
    return tree


def gather_params(params: Pytree, specs: Pytree, mesh) -> Pytree:
    """The full tree back from every rank's local tree (each rank gets it):
    the inverse of ``shard_params``.  Every rank must call it."""

    world = None if dist.get_world_size() == 1 else dist.group.WORLD

    def full(path, leaf, _):
        spec = _lookup(specs, path)
        if all(shard_index(mesh, e)[0] == 1 for e in spec):
            return leaf
        parts = all_gather_cat(leaf[None], world, dim=0)  # one per global rank
        out = leaf.new_empty([s * shard_index(mesh, e)[0] for s, e in zip(leaf.shape, spec)])
        for r, part in enumerate(parts):
            coords = np.unravel_index(mesh.ranks.index(r), tuple(mesh.shape.values()))
            at = dict(zip(mesh.axis_names, (int(c) for c in coords)))
            view = out
            for d, e in enumerate(spec):
                n, i = 1, 0
                for a in _entry_axes(e):
                    n, i = n * mesh.shape[a], i * mesh.shape[a] + at[a]
                if n > 1:
                    view = view.narrow(d, i * leaf.shape[d], leaf.shape[d])
            view.copy_(part)
        return out

    return _walk(params, full)


def _lookup(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


# ---------------------------------------------------------------------------
# the model stack's layout under a mesh
# ---------------------------------------------------------------------------
def model_shards(mesh) -> tuple[int, int, Any]:
    """(ranks along ``model``, this rank's coordinate, its process group):
    (1, 0, None) without a mesh or a ``model`` axis."""
    if mesh is None or "model" not in mesh.shape:
        return 1, 0, None
    return mesh.shape["model"], mesh.local_rank("model"), mesh.get_group("model")


def slot_layout(n_slots: int, mesh) -> tuple[int, int]:
    """(slots a rank holds, index of its first slot): ``n_slots`` over the
    DP axes where they divide them (``batch_specs``' rule), else every slot
    on every rank."""
    if mesh is None:
        return n_slots, 0
    dp = dp_axes(mesh)
    n, i = shard_index(mesh, dp)
    if n == 1 or not _div(n_slots, n):
        return n_slots, 0
    return n_slots // n, i * (n_slots // n)


def attention_heads(cfg, mesh) -> tuple[range, list[int]]:
    """(this rank's query heads, the KV heads its attention reads and its
    cache holds, in order).  Heads over ``model`` where ``wq``/``wk`` are
    column-parallel; where the KV heads do not divide ``model`` they are
    computed whole on every rank (the contracting-dim rule), and a rank
    keeps those of its query heads' GQA groups: the distinct ones when each
    covers an equal run of its query heads, else one per query head."""
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    m, r, _ = model_shards(mesh)
    if m == 1:
        return range(h), list(range(kv))
    q_split = _param_rule("mixer/wq", (d, h * dh), mesh, cfg)[-1] == "model"
    q = range(r * h // m, (r + 1) * h // m) if q_split else range(h)
    if _param_rule("mixer/wk", (d, kv * dh), mesh, cfg)[-1] == "model":
        return q, list(range(r * kv // m, (r + 1) * kv // m))
    g = h // kv
    need = [j // g for j in q]
    uniq = sorted(set(need))
    if len(q) % len(uniq) == 0 and need == [u for u in uniq for _ in range(len(q) // len(uniq))]:
        return q, uniq
    return q, need


# ---------------------------------------------------------------------------
# collectives (no-ops in a group of one)
# ---------------------------------------------------------------------------
COLLECTIVES: dict[str, dict[str, int]] = {}


def _count(op: str, t: torch.Tensor) -> None:
    rec = COLLECTIVES.setdefault(op, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, accumulated in fp32 and rounded once
    to ``x``'s type."""
    if _size(group) == 1:
        return x
    y = x.float().contiguous() if x.dtype != torch.float32 else x.contiguous()
    _count("all_reduce", y)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (bf16,
    which gloo does not take, moves as its bytes)."""
    n = _size(group)
    if n == 1:
        return x
    y = x.contiguous()
    if y.dtype == torch.bfloat16:
        y = y.view(torch.uint8)  # the last dim doubles: each element's bytes stay together
    parts = [torch.empty_like(y) for _ in range(n)]
    _count("all_gather", y)
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bfloat16) if x.dtype == torch.bfloat16 else out


def argmax_sharded(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """``torch.argmax(full, dim=-1)`` of a tensor split over ``group``
    along its last dim (this rank's part ``x`` starts at ``offset``): ties
    go to the lowest global index, as ``torch.argmax`` breaks them."""
    if _size(group) == 1:
        return torch.argmax(x, dim=-1)
    xf = x.float()
    pair = torch.stack([xf.amax(dim=-1).double(), (xf.argmax(dim=-1) + offset).double()])
    both = all_gather_cat(pair[None], group, dim=0)  # (ranks, 2, N); indices exact in fp64
    first = torch.argmax(both[:, 0], dim=0)  # the first rank holding the maximum
    return both[:, 1].gather(0, first[None])[0].to(torch.int64)


def world_gather(x: torch.Tensor, src_ranks: list[int]) -> torch.Tensor:
    """The concatenation (dim 0) of ``x`` from each of ``src_ranks`` in that
    order, on every rank of the world."""
    if dist.get_world_size() == 1:
        return x
    parts = all_gather_cat(x[None], dist.group.WORLD, dim=0)  # one per global rank
    return torch.cat([parts[r] for r in src_ranks])
