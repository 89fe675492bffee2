"""Sharded execution of canonical programs (data-parallel mesh partitioning).

Port of ``repro/core/partition.py``.  The paper's flagship application is
embarrassingly parallel over horizontal grid columns (CLOUDSC's NPROMA
blocking, §5.2); after a priori normalization the minimal-stride permutation
has already surfaced that parallel iterator in every canonical nest.  This
module picks it up and maps it onto a mesh axis:

* ``plan_program_partition`` — the planner, copied from the reference (IR
  code; only the import roots changed, and ``ProgramPartition.spec`` gives a
  tuple of axis names where the reference builds a ``PartitionSpec``).  Per
  canonical nest it walks the iterators outermost-first and selects the
  first *parallel* iterator (no dependence carried by it) whose accesses are
  **shard-aligned**: the iterator appears in exactly one dimension of every
  access that uses it, with coefficient 1 and offset 0, covering the full
  array extent.  Everything else vetoes:

    - carried / scan iterators (recurrences)        -> try the next iterator
    - constant-offset or strided use (``A[p-1]``)   -> cross-shard flow, veto
    - guards referencing the iterator               -> shard-position
      dependent control flow, veto
    - accumulations over the sharded iterator whose extent does not divide
      the mesh (padding would feed garbage into the all-reduce), veto

  A nest with no shardable iterator falls back to replication, and every
  array it touches is pinned replicated program-wide.

* ``compile_sharded`` — the executor, SPMD over ``torch.distributed``.  The
  returned function runs on every rank of the mesh axis's group with the
  same global inputs.  It pads each sharded dimension up to a multiple of
  the shard count, takes this rank's slice as a contiguous tensor on the
  mesh's device, runs the shard-local program's nests through the port's
  own per-nest lowering (``_NestEmitter``: so K1, K2 and K3 launch inside
  each shard as they do unsharded), all-reduces after the nests the plan
  names (``+`` as the reference's ``old + all_reduce(new - old)``, ``max``
  and ``min`` as ``ReduceOp.MAX`` / ``MIN``), then all-gathers the sharded
  arrays the program writes, removes the padding and returns global tensors
  on every rank.  Sharded arrays no nest writes are returned as the global
  input on the device, without a collective.  When the mesh is None, its
  axis has size 1 or nothing shards, it returns ``compile_torch``'s own
  function and a plan with every veto reason: sharding is always a sound
  no-op to request.

Padding stays in the pad: CLOUDSC's divisions turn zero padding into inf or
NaN there, and the outputs never include it.  ``COLLECTIVES`` counts every
collective the executor runs, by op: calls and the bytes this rank sent.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from .codegen import Schedule, _NestEmitter, _written_arrays, compile_torch
from .dependence import EQ, nest_direction_vectors
from .ir import (
    Array,
    Computation,
    Loop,
    Node,
    Program,
    loop_iterators,
    nest_computations,
    walk,
)

# accumulate ops with an all-reduce ('*' stays vetoed, as in the reference)
_SHARD_REDUCE = {"+", "max", "min"}


@dataclass(frozen=True)
class NestPartition:
    """Sharding decision for one top-level nest."""

    iterator: str | None                       # None -> replicated fallback
    reduces: tuple[tuple[str, str], ...] = ()  # (array, op) all-reduced after
    reason: str = "sharded"                    # veto reason when iterator=None


@dataclass
class ProgramPartition:
    """Whole-program sharding plan: one spec per array, one choice per nest."""

    axis: str
    n_shards: int
    array_dims: dict[str, int | None]  # array -> sharded dim (None: replicated)
    nests: list[NestPartition] = field(default_factory=list)

    @property
    def sharded(self) -> bool:
        """True when at least one nest actually shards an iterator."""
        return any(n.iterator is not None for n in self.nests)

    def padded_extent(self, extent: int) -> int:
        """``extent`` rounded up to a multiple of the shard count."""
        return -(-extent // self.n_shards) * self.n_shards

    def spec(self, shape: tuple[int, ...], name: str) -> tuple[str | None, ...]:
        """Array ``name``'s mesh axis or None per dimension (what the
        reference's ``PartitionSpec`` holds)."""
        d = self.array_dims.get(name)
        return tuple(self.axis if i == d else None for i in range(len(shape)))

    def describe(self) -> str:
        """Human-readable rendering of the per-nest/per-array decisions."""
        lines = [f"partition over axis '{self.axis}' x{self.n_shards}:"]
        for k, np_ in enumerate(self.nests):
            if np_.iterator is None:
                lines.append(f"  nest {k}: replicated ({np_.reason})")
            else:
                red = "".join(f" all-reduce({a},{op})" for a, op in np_.reduces)
                lines.append(f"  nest {k}: shard {np_.iterator}{red}")
        reps = sorted(a for a, d in self.array_dims.items() if d is None)
        shs = {a: d for a, d in self.array_dims.items() if d is not None}
        lines.append("  arrays: " + ", ".join(
            [f"{a}@dim{d}" for a, d in sorted(shs.items())] + reps))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-nest candidate analysis
# ---------------------------------------------------------------------------
def _loops_of(nest: Node) -> dict[str, Loop]:
    out: dict[str, Loop] = {}

    def rec(n: Node) -> None:
        if isinstance(n, Loop):
            out[n.iterator] = n
            for b in n.body:
                rec(b)

    rec(nest)
    return out


def _nest_arrays(nest: Node) -> set[str]:
    return {a.array for c in nest_computations(nest) for a in c.accesses()}


def _candidate(
    program: Program, nest: Loop, p: str, n_shards: int
) -> tuple[dict[str, tuple], dict[str, str]] | str:
    """Try sharding ``nest`` over iterator ``p``.

    Returns ``(requirements, reduces)`` — ``requirements`` maps each touched
    array to ``('dim', d)`` (shard on dim d) or ``('rep',)`` (replicate),
    ``reduces`` maps accumulated arrays to their all-reduce op — or a veto
    reason string.
    """
    loop = _loops_of(nest)[p]
    if loop.start != 0 or loop.step != 1:
        return f"{p}: non-canonical bounds [{loop.start}::{loop.step}]"
    if loop.trip_count < n_shards:
        return f"{p}: extent {loop.trip_count} < {n_shards} shards"

    # parallel? no dependence among the loop's own computations carried by p
    comps_p = nest_computations(loop)
    vecs = nest_direction_vectors([p], {p: loop.trip_count}, comps_p)
    if not all(v.directions[0] == EQ for v in vecs):
        return f"{p}: carried dependence (recurrence stays per-shard-serial)"

    req: dict[str, tuple] = {}
    reduces: dict[str, str] = {}

    def merge(arr: str, want: tuple) -> str | None:
        have = req.get(arr)
        if have is None or have == want:
            req[arr] = want
            return None
        return f"{arr}: conflicting shard requirements {have} vs {want}"

    for _, comp in walk(nest):
        uses_p = p in comp.iterators()
        if any(g.coeff(p) != 0 for g in comp.guards):
            return f"{p}: guard of '{comp.name}' references the shard iterator"
        for a, is_write in [(comp.write, True)] + [(r, False) for r in comp.reads]:
            dims_p = [d for d, ix in enumerate(a.index) if ix.coeff(p) != 0]
            if not dims_p:
                if is_write and uses_p:
                    # value varies with p, write target does not: a reduction
                    # over the sharded iterator -> all-reduce after the nest
                    if comp.accumulate not in _SHARD_REDUCE:
                        return (f"{p}: '{comp.name}' writes {a.array} without "
                                f"an all-reducible accumulate")
                    if loop.trip_count % n_shards != 0:
                        return (f"{p}: reduction over a padded extent "
                                f"({loop.trip_count} % {n_shards} != 0)")
                    prev = reduces.setdefault(a.array, comp.accumulate)
                    if prev != comp.accumulate:
                        return f"{a.array}: mixed reduce ops {prev}/{comp.accumulate}"
                    err = merge(a.array, ("rep",))
                else:
                    # access never sees p -> this nest needs the array whole
                    err = merge(a.array, ("rep",))
                if err:
                    return err
                continue
            if len(dims_p) != 1:
                return f"{p}: {a.array} uses the shard iterator in two dims"
            d = dims_p[0]
            ix = a.index[d]
            if ix.coeffs != ((p, 1),) or ix.const != 0:
                return (f"{p}: {a.array}[..{ix!r}..] is offset/strided — "
                        "cross-shard flow")
            arr = program.array(a.array)
            if loop.stop != arr.shape[d]:
                return (f"{p}: loop [0:{loop.stop}] covers {a.array} dim {d} "
                        f"({arr.shape[d]}) partially")
            err = merge(a.array, ("dim", d))
            if err:
                return err
    # the all-reduce runs only after the whole nest: any read of a reduce
    # target inside the nest (e.g. a sibling computation outside the
    # candidate loop, or an explicit self-read) would observe per-shard
    # partial sums -> veto
    for arr in reduces:
        for c in nest_computations(nest):
            if any(r.array == arr for r in c.reads):
                return (f"{arr}: reduce target read inside the nest "
                        "(partial sums would be visible)")
    return req, reduces


# ---------------------------------------------------------------------------
# program-level planning
# ---------------------------------------------------------------------------
def plan_program_partition(
    program: Program,
    n_shards: int,
    axis: str = "data",
    enabled: Sequence[bool] | None = None,
) -> ProgramPartition:
    """One consistent sharding plan for the whole (normalized) program.

    Greedy over nests in program order, outermost iterator first; arrays get
    exactly one spec program-wide.  When a replicated nest touches an array
    an earlier nest sharded, that array is pinned replicated and planning
    restarts (bounded by the array count), so the result is always globally
    consistent — nests that cannot agree simply stay replicated.
    """
    if enabled is None:
        enabled = [True] * len(program.body)
    forced_rep: set[str] = set()
    for _ in range(len(program.arrays) + 1):
        assigned: dict[str, int | None] = {}
        nests: list[NestPartition] = []
        restart = False
        for nest, en in zip(program.body, enabled):
            chosen: NestPartition | None = None
            chosen_req: dict[str, tuple] = {}
            reason = "sharding disabled for this nest"
            # arrays whose *replication* would admit this nest's best
            # candidate (it needs them whole — e.g. as all-reduce targets —
            # while an earlier nest sharded them).  Replicating an array is
            # always sound, so prefer unlocking this nest over keeping a
            # possibly-trivial earlier sharding.
            unlockable: set[str] | None = None
            if en and isinstance(nest, Loop):
                for p in loop_iterators(nest):
                    cand = _candidate(program, nest, p, n_shards)
                    if isinstance(cand, str):
                        if reason == "sharding disabled for this nest":
                            reason = cand  # outermost veto, for diagnostics
                        continue
                    req, reduces = cand
                    clashes: set[str] = set()
                    fixable = True
                    for arr, want in req.items():
                        d = want[1] if want[0] == "dim" else None
                        if (d is not None and arr in forced_rep) or (
                            arr in assigned and assigned[arr] != d
                        ):
                            clashes.add(arr)
                            # only a want-replicated / have-sharded clash is
                            # curable by forcing replication
                            if d is not None:
                                fixable = False
                    if not clashes:
                        chosen = NestPartition(p, tuple(sorted(reduces.items())))
                        chosen_req = req
                        break
                    if reason == "sharding disabled for this nest":
                        reason = (f"{p}: array spec conflict on "
                                  f"{'/'.join(sorted(clashes))} (replicated "
                                  "for whole-program consistency)")
                    if unlockable is None and fixable:
                        unlockable = clashes
            if chosen is None:
                if unlockable:
                    forced_rep |= unlockable
                    restart = True
                    break
                touched = _nest_arrays(nest)
                conflict = {a for a in touched if assigned.get(a) is not None}
                if conflict:
                    forced_rep |= conflict
                    restart = True
                    break
                for a in touched:
                    assigned.setdefault(a, None)
                nests.append(NestPartition(None, reason=reason))
            else:
                for arr, want in chosen_req.items():
                    assigned[arr] = want[1] if want[0] == "dim" else None
                nests.append(chosen)
        if not restart:
            for a in program.arrays:  # untouched arrays stay replicated
                assigned.setdefault(a.name, None)
            return ProgramPartition(axis, n_shards, assigned, nests)
    raise AssertionError("partition planning failed to converge")  # pragma: no cover


# ---------------------------------------------------------------------------
# shard-local program + executor
# ---------------------------------------------------------------------------
def _rewrite_extent(node: Node, iterator: str, stop: int) -> Node:
    if isinstance(node, Computation):
        return node
    body = tuple(_rewrite_extent(b, iterator, stop) for b in node.body)
    if node.iterator == iterator:
        return replace(node, stop=stop, body=body)
    return replace(node, body=body)


def local_program(program: Program, plan: ProgramPartition) -> Program:
    """The per-shard program: sharded dims and loop extents divided (padded
    up to the mesh first when the extent does not divide)."""
    n = plan.n_shards
    arrays = []
    for a in program.arrays:
        d = plan.array_dims.get(a.name)
        if d is None:
            arrays.append(a)
        else:
            shape = list(a.shape)
            shape[d] = plan.padded_extent(shape[d]) // n
            arrays.append(Array(a.name, tuple(shape), a.dtype))
    body = []
    for nest, np_ in zip(program.body, plan.nests):
        if np_.iterator is None:
            body.append(nest)
        else:
            ext = plan.padded_extent(_loops_of(nest)[np_.iterator].stop) // n
            body.append(_rewrite_extent(nest, np_.iterator, ext))
    return Program(program.name, tuple(arrays), tuple(body), program.temps)


# Collectives the executor ran, by op: calls and the bytes this rank sent.
COLLECTIVES: dict[str, dict[str, int]] = {}

_REDUCE_OPS = {"+": "SUM", "max": "MAX", "min": "MIN"}


def _count(op: str, t: torch.Tensor) -> None:
    rec = COLLECTIVES.setdefault(op, {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


def _all_reduce(op: str, old: torch.Tensor, new: torch.Tensor, group) -> torch.Tensor:
    """The nest's result across the group.  An accumulate folds into the
    (replicated) prior contents, so ``+`` sums only the per-shard
    contributions and adds the base back once."""
    part = new - old if op == "+" else new
    dist.all_reduce(part, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]), group=group)
    _count("all_reduce", part)
    return old + part if op == "+" else part


def _all_gather(local: torch.Tensor, group, n: int, dim: int, extent: int) -> torch.Tensor:
    """The global array from every rank's shard along ``dim``, unpadded."""
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    _count("all_gather", local)
    return torch.cat(parts, dim=dim).narrow(dim, 0, extent).contiguous()


def _shard(value: Any, dim: int | None, rank: int, shape: tuple[int, ...],
           device: torch.device) -> torch.Tensor:
    """This rank's contiguous float32 slice of a global input along ``dim``,
    zero-padded where the last shard runs past the extent (the whole input
    when ``dim`` is None), on ``device``."""
    t = torch.as_tensor(value)
    if dim is None:
        return t.to(device=device, dtype=torch.float32, copy=True,
                    memory_format=torch.contiguous_format)
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    lo = rank * shape[dim]
    size = min(shape[dim], t.shape[dim] - lo)
    if size > 0:
        out.narrow(dim, 0, size).copy_(t.narrow(dim, lo, size))
    return out


def compile_sharded(
    program: Program,
    per_nest: Schedule | Sequence[Schedule] = Schedule(),
    mesh: Any = None,
    axis: str = "data",
) -> tuple[Callable[[Mapping[str, Any]], dict[str, torch.Tensor]], ProgramPartition]:
    """Like ``compile_torch`` but executed across ``mesh``'s ``axis``.

    Nests whose ``Schedule.shard_axis`` names ``axis`` are considered for
    sharding (a broadcast single Schedule enables every nest); the planner
    still vetoes per nest.  Returns ``(fn, plan)``; when nothing shards the
    fn IS ``compile_torch``'s lowering and the plan records every veto
    reason.  The program runs on ``mesh.device`` (on the card without a
    mesh).
    """
    if isinstance(per_nest, Schedule):
        schedules: Sequence[Schedule] = (per_nest,) * len(program.body)
    else:
        schedules = tuple(per_nest)
        if len(schedules) != len(program.body):
            raise ValueError(
                f"{program.name}: got {len(schedules)} schedules for "
                f"{len(program.body)} top-level nests")
    n = int(mesh.shape[axis]) if mesh is not None else 1
    if n <= 1:  # degenerate mesh: report an honest all-replicated plan
        enabled: Sequence[bool] = [False] * len(program.body)
    else:
        enabled = [s.shard_axis == axis for s in schedules]
    plan = plan_program_partition(program, max(n, 1), axis, enabled)
    if mesh is None or n <= 1 or not plan.sharded:
        dev = mesh.device if mesh is not None else "cuda"
        return compile_torch(program, schedules, device=dev), plan

    local = local_program(program, plan)
    dev, group = mesh.device, mesh.get_group(axis)
    emitters = [_NestEmitter(local, s, nest) for nest, s in zip(local.body, schedules)]
    written = {a for nest in program.body for a in _written_arrays(nest)}

    def fn(inputs: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Run this rank's shard of every nest, all-reducing as planned;
        returns the global array environment."""
        rank = mesh.local_rank(axis)
        env = {
            a.name: (torch.zeros(a.shape, dtype=torch.float32, device=dev)
                     if a.name in local.temps
                     else _shard(inputs[a.name], plan.array_dims.get(a.name), rank,
                                 a.shape, dev))
            for a in local.arrays
        }
        for em, np_ in zip(emitters, plan.nests):
            old = {arr: env[arr].clone() for arr, _ in np_.reduces}
            em.run(env)
            for arr, op in np_.reduces:
                env[arr] = _all_reduce(op, old[arr], env[arr], group)
        out = {}
        for a in program.arrays:
            d = plan.array_dims.get(a.name)
            if d is None:
                out[a.name] = env[a.name]
            elif a.name in written:
                out[a.name] = _all_gather(env[a.name], group, n, d, a.shape[d])
            else:
                out[a.name] = _shard(inputs[a.name], None, 0, a.shape, dev)
        return out

    return fn, plan


def run_sharded(
    program: Program,
    inputs: Mapping[str, Any],
    mesh: Any,
    per_nest: Schedule | Sequence[Schedule] | None = None,
    axis: str = "data",
) -> dict[str, torch.Tensor]:
    """One-shot sharded execution (mirrors ``run_torch``)."""
    sched = per_nest if per_nest is not None else Schedule(shard_axis=axis)
    fn, _ = compile_sharded(program, sched, mesh=mesh, axis=axis)
    return fn(dict(inputs))
