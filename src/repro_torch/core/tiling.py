"""Grid-tiling planner for canonical nests (the nest kernel's front half).

Port of ``repro/core/tiling.py``: the same legality checks, iterator roles
and halos, so a nest the reference tiles is tiled here with the same plan.
The block choice is the port's own.  A Triton block is a power of two per
axis, so each axis's block is its tile rounded up to a power of two, and the
kernel masks the lanes past the tile (the reference's tiles can be any size:
explicit tiles are clamped to the trip count, and inner reduction axes take
their whole trip).  Without an explicit tile the planner fills a budget of
``MAX_BLOCK_ELEMS`` slab elements from the innermost axis outwards; an
explicit tile whose blocks exceed the budget is halved, largest axis first,
until it fits.  No TPU lane/sublane alignment or VMEM sizing is involved.

The nest kernel reads stencil halos with masked loads, so ``TilePlan.halo``
is informational here: it records how far accesses reach outside each array
exactly as the reference's padded views would.

The planner is strict: anything it cannot prove tileable (carried
dependences, multi-iterator or non-unit-coefficient subscripts, scalar
targets, slabs over the block budget) raises ``TilingError``, and the caller
routes the nest to the generic torch lowering.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

from .codegen import _ACC_INIT, Unsupported
from .dependence import EQ, nest_direction_vectors
from .ir import (
    Access,
    Affine,
    Computation,
    Loop,
    Node,
    Program,
    loop_iterators,
    nest_computations,
)

# Slab elements per program (all axes' blocks multiplied): 16 KB of fp32
# per live value, 32 registers a thread at 4 warps.
MAX_BLOCK_ELEMS = 4096
# Widest default block of the innermost parallel axis.
MAX_INNER_BLOCK = 1024
# Default block of the grid reduction axis.
DEFAULT_REDUCE_BLOCK = 64


def next_pow2(n: int) -> int:
    """The smallest power of two >= ``n`` (1 for n <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


class TilingError(Unsupported):
    """The nest is outside the tiled class; the generic lowering runs it."""


@dataclass(frozen=True)
class TiledIter:
    """One iterator of the nest mapped onto the grid (or kept in-tile)."""

    name: str
    start: int
    stop: int
    tile: int
    role: str  # 'parallel' | 'reduce_grid' | 'reduce_inner'

    @property
    def trip(self) -> int:
        """Iteration count of the underlying loop range."""
        return max(0, self.stop - self.start)

    @property
    def n_tiles(self) -> int:
        """Grid extent along this iterator (ceil-divided, at least 1)."""
        return max(1, -(-self.trip // self.tile))

    @property
    def block(self) -> int:
        """Power-of-two block holding one tile (lanes past the tile masked)."""
        return next_pow2(self.tile)


@dataclass(frozen=True)
class DimMap:
    """How one array dimension of an access maps onto the plan.

    ``iterator`` is None for constant subscripts; ``const`` carries the
    affine constant (the stencil offset / loop-start shift folded into the
    operand view's origin by the emitter).
    """

    iterator: str | None
    const: int


@dataclass
class TilePlan:
    """Complete tiling decision for one nest: axis roles, grid, halos."""

    kind: str                         # 'parallel' | 'reduce'
    parallel: tuple[TiledIter, ...]   # loop order (outer -> inner)
    reduce_inner: tuple[TiledIter, ...]
    reduce_grid: TiledIter | None
    comps: tuple[Computation, ...]    # program order
    grid: tuple[int, ...]             # parallel tiles (+ reduction tiles last)
    halo: dict[str, tuple[tuple[int, int], ...]]  # array -> per-dim (lo, hi) reach

    @property
    def axes(self) -> tuple[TiledIter, ...]:
        """Canonical slab axis order: parallel, inner reductions, grid reduction."""
        tail = (self.reduce_grid,) if self.reduce_grid is not None else ()
        return self.parallel + self.reduce_inner + tail

    @property
    def block_elems(self) -> int:
        """Elements of one program's full slab (every axis's block)."""
        n = 1
        for a in self.axes:
            n *= a.block
        return n

    @property
    def axis_of(self) -> dict[str, int]:
        """Iterator name -> position in the canonical slab axis order."""
        return {a.name: k for k, a in enumerate(self.axes)}

    @property
    def iter_of(self) -> dict[str, TiledIter]:
        """Iterator name -> its ``TiledIter``."""
        return {a.name: a for a in self.axes}

    def access_dims(self, a: Access) -> list[DimMap]:
        """Per-dimension ``DimMap`` of one access under this plan."""
        return [_dim_map(ix, self.iter_of) for ix in a.index]


def _dim_map(ix: Affine, iters: Mapping[str, TiledIter]) -> DimMap:
    its = ix.iterators()
    if not its:
        if ix.coeffs:  # non-affine marker
            raise TilingError("non-affine subscript")
        return DimMap(None, ix.const)
    if len(its) != 1 or ix.coeff(its[0]) != 1:
        raise TilingError(f"subscript {ix!r} is not a unit-coefficient iterator")
    if its[0] not in iters:
        raise TilingError(f"iterator {its[0]} not bound by the nest")
    return DimMap(its[0], ix.const)


def _loop_bounds(nest: Node) -> dict[str, tuple[int, int]]:
    out: dict[str, tuple[int, int]] = {}

    def rec(n: Node) -> None:
        if isinstance(n, Loop):
            if n.step != 1:
                raise TilingError(f"loop {n.iterator} has step {n.step}")
            out[n.iterator] = (n.start, n.stop)
            for b in n.body:
                rec(b)

    rec(nest)
    return out


def _fit_tiles(tiles: list[int], fixed: int) -> list[int]:
    """Halve the largest tile until the blocks (times ``fixed`` elements of
    whole-trip axes) fit ``MAX_BLOCK_ELEMS``."""
    tiles = list(tiles)
    while tiles and fixed * math.prod(next_pow2(t) for t in tiles) > MAX_BLOCK_ELEMS:
        k = max(range(len(tiles)), key=lambda j: (next_pow2(tiles[j]), -j))
        if tiles[k] <= 1:
            break
        tiles[k] = next_pow2(tiles[k]) // 2
    return tiles


def _default_tiles(par_trips: list[int], red_trip: int | None, fixed: int) -> list[int]:
    """Port-chosen tiles: the grid reduction axis gets ``DEFAULT_REDUCE_BLOCK``,
    then the parallel axes fill the remaining budget from the innermost
    outwards (the innermost at most ``MAX_INNER_BLOCK`` wide)."""
    left = max(1, MAX_BLOCK_ELEMS // fixed)
    red = None
    if red_trip is not None:
        red = min(next_pow2(red_trip), DEFAULT_REDUCE_BLOCK, left)
        left = max(1, left // red)
    out = [1] * len(par_trips)
    for k in range(len(par_trips) - 1, -1, -1):
        cap = MAX_INNER_BLOCK if k == len(par_trips) - 1 else left
        out[k] = max(1, min(next_pow2(par_trips[k]), cap, left))
        left = max(1, left // out[k])
    return out + ([red] if red is not None else [])


def plan_nest_tiling(
    program: Program,
    nest: Node,
    tile: Sequence[int] | None = None,
) -> TilePlan:
    """Partition a canonical nest's iterators into a grid of programs.

    Raises ``TilingError`` for anything outside the tiled class (carried
    dependences, non-unit subscripts, scalar writes, mixed write/reduction
    roles) — callers fall back to the generic lowering.
    """
    if not isinstance(nest, Loop):
        raise TilingError("bare computation")
    bounds = _loop_bounds(nest)
    iterators = list(loop_iterators(nest))
    comps = nest_computations(nest)
    trips = {it: max(0, bounds[it][1] - bounds[it][0]) for it in iterators}
    if any(t <= 0 for t in trips.values()):
        raise TilingError("empty iteration domain")

    vectors = nest_direction_vectors(iterators, trips, comps)
    carried = [it for k, it in enumerate(iterators)
               if any(v.directions[k] != EQ for v in vectors)]
    if carried:
        raise TilingError(f"carried iterators {carried} (recurrence)")

    used = {it for c in comps for it in c.iterators()}
    if set(iterators) - used:
        raise TilingError("nest has loops no computation references")

    # Per-computation iterator roles.  Reduction axes = used but not written.
    red_its: list[str] = []
    for c in comps:
        w_its = {it for ix in c.write.index for it in ix.iterators()}
        extra = [it for it in iterators if it in set(c.iterators()) - w_its]
        if extra:
            if c.accumulate is None:
                raise TilingError(f"{c.name}: assignment under non-write axes")
            red_its.extend(it for it in extra if it not in red_its)
        if not c.write.index:
            raise TilingError(f"{c.name}: scalar write target")

    if red_its:
        if len(comps) != 1:
            raise TilingError("reduction nest with multiple computations")
        if comps[0].accumulate not in _ACC_INIT:
            raise TilingError(f"unsupported accumulate {comps[0].accumulate!r}")
        kind = "reduce"
    else:
        kind = "parallel"
    par_its = [it for it in iterators if it not in red_its]
    # An accumulate under the full parallel grid re-executes once per grid
    # step of any axis it does not use — only safe when it uses them all.
    for c in comps:
        if c.accumulate is not None and kind == "parallel":
            if set(par_its) - set(c.iterators()):
                raise TilingError(f"{c.name}: accumulate misses grid iterators")

    # ---- tile sizes -------------------------------------------------------
    red_order = [it for it in iterators if it in red_its]
    grid_red_it = red_order[-1] if red_order else None
    fixed = math.prod(next_pow2(trips[it]) for it in red_order[:-1])
    if fixed > MAX_BLOCK_ELEMS:
        raise TilingError(
            f"inner reduction axes {red_order[:-1]} exceed the block budget")
    par_tiles = [trips[it] for it in par_its]
    red_tile = trips[grid_red_it] if grid_red_it else None
    trip_list = par_tiles + ([red_tile] if red_tile else [])
    if tile:
        want = [max(1, int(x)) for x in tile]
        if kind == "reduce" and len(want) > 1:
            red_tile = min(want.pop(), red_tile)
        want = want[-len(par_its):] if par_its else []
        for k, w in zip(range(len(par_its) - len(want), len(par_its)), want):
            par_tiles[k] = min(w, par_tiles[k])
        all_tiles = par_tiles + ([red_tile] if red_tile else [])
        all_tiles = _fit_tiles(all_tiles, fixed)
    else:
        all_tiles = _default_tiles(par_tiles, red_tile, fixed)
    all_tiles = [min(t, tr) for t, tr in zip(all_tiles, trip_list)]
    par_tiles = all_tiles[: len(par_its)]
    if grid_red_it:
        red_tile = all_tiles[-1]

    parallel = tuple(
        TiledIter(it, *bounds[it], tile=t, role="parallel")
        for it, t in zip(par_its, par_tiles)
    )
    reduce_inner = tuple(
        TiledIter(it, *bounds[it], tile=trips[it], role="reduce_inner")
        for it in red_order[:-1]
    )
    reduce_grid = (
        TiledIter(grid_red_it, *bounds[grid_red_it], tile=red_tile,
                  role="reduce_grid")
        if grid_red_it else None
    )
    grid = tuple(p.n_tiles for p in parallel)
    if reduce_grid is not None:
        grid = grid + (reduce_grid.n_tiles,)

    plan = TilePlan(
        kind=kind, parallel=parallel, reduce_inner=reduce_inner,
        reduce_grid=reduce_grid, comps=tuple(comps), grid=grid, halo={},
    )
    _validate_accesses(program, plan)
    plan.halo = _halo(program, plan)
    return plan


def _validate_accesses(program: Program, plan: TilePlan) -> None:
    writes: dict[str, tuple] = {}
    par = {a.name for a in plan.parallel}
    for c in plan.comps:
        for a in (c.write,) + c.reads:
            dims = plan.access_dims(a)  # raises on non-unit subscripts
            seen = [d.iterator for d in dims if d.iterator is not None]
            if len(seen) != len(set(seen)):
                raise TilingError(f"{a.array}: iterator used in two dims")
            if len(dims) != len(program.array(a.array).shape):
                raise TilingError(f"{a.array}: rank mismatch")
        wdims = plan.access_dims(c.write)
        if any(d.iterator is not None and d.iterator not in par for d in wdims):
            raise TilingError(f"{c.name}: write subscript uses reduction axis")
        prev = writes.get(c.write.array)
        if prev is not None and prev != c.write.index:
            raise TilingError(f"{c.write.array}: two write maps in one nest")
        writes[c.write.array] = c.write.index
        # reads of an array written earlier in the nest must match the write
        # map exactly (the emitter forwards the in-kernel slab)
        for r in c.reads:
            if r.array in writes and writes[r.array] != r.index:
                raise TilingError(f"{r.array}: read of stale in-kernel write")


def _halo(program: Program, plan: TilePlan) -> dict[str, tuple[tuple[int, int], ...]]:
    """Per array dimension, how far tile-aligned views reach outside
    [0, extent): a dimension subscripted ``it + c`` spans ``n_tiles * tile``
    elements from ``start + c`` (stencil offsets plus the tile-rounding
    tail), the pad the reference's padded operand views need."""
    iters = plan.iter_of
    lo: dict[str, list[int]] = {}
    hi: dict[str, list[int]] = {}
    for c in plan.comps:
        for a in (c.write,) + c.reads:
            shape = program.array(a.array).shape
            l = lo.setdefault(a.array, [0] * len(shape))
            h = hi.setdefault(a.array, [0] * len(shape))
            for d, dm in enumerate(plan.access_dims(a)):
                if dm.iterator is None:
                    if not 0 <= dm.const < shape[d]:
                        raise TilingError(f"{a.array}: constant index OOB")
                    continue
                ti = iters[dm.iterator]
                origin = ti.start + dm.const
                span = ti.n_tiles * ti.tile
                l[d] = max(l[d], -origin)
                h[d] = max(h[d], origin + span - shape[d])
    return {k: tuple(zip(lo[k], hi[k])) for k in lo}
