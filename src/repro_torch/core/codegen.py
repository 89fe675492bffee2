"""Code generation: loop-nest IR -> executable torch code.

Port of ``repro/core/codegen.py``.  Three lowerings, as in the reference:

* ``execute_numpy``  — the semantic oracle (a copy of the reference's).
* ``compile_torch(mode='as_written')`` — the baseline-compiler analogue: only
  each computation's innermost legal loop is vectorized, every other loop
  runs sequentially (a Python loop over eager torch ops).  No idioms.
* ``compile_torch(mode='canonical')`` — the scheduled path: every legal
  iterator is vectorized within the materialization budget, reductions become
  tensor reductions, and BLAS-class computations go to ``torch.einsum`` or,
  under ``Schedule.pallas_gemm``, to the hand-written CUDA GEMM through
  ``repro_torch.kernels.ops.einsum2``.

On top of the canonical path, the recipe-selected lowerings:

* ``Schedule.pallas_nest`` / ``Schedule.pallas_reduce`` route whole canonical
  nests through the generated Triton nest kernel
  (``repro_torch.kernels.nest_kernel``).
* ``Schedule.scan`` runs carried (recurrence) loops step by step over row
  views of their leading-axis operands, so each step's accesses lower to
  plain slices instead of index-grid gathers and scatters.

Differences from the reference that are deliberate:

* Planning (dependence analysis, vectorization plans, tiling plans) runs once
  in ``compile_torch``; the returned function only does tensor work.
* A loop runs eagerly from Python when it stays sequential, where XLA
  compiles the reference's ``fori_loop``.  So a perfect single-assignment
  nest that the dependence analysis keeps sequential is checked exactly,
  point by point (``_conflict_free``), and vectorized when no two points
  depend on each other.
* Arrays are updated in place.  Inputs are copied (as float32, the precision
  ``jnp.asarray`` gives with x64 off) on entry, so the caller's tensors are
  never written.
* A nest outside the tiled class, or a contraction that is not a clean
  two-operand product, is sent to the torch lowering by the planner or the
  classifier *before* any launch, and each such decision is counted in
  ``ROUTED``.  An error while building or launching a kernel propagates: the
  reference swallows both (a failing ``emit_nest`` and any exception of
  ``einsum2``); the port does not.
* JAX clamps out-of-range gathers and drops out-of-range scatters; torch
  raises.  The emitter bounds every index from the loop ranges and clamps
  (gathers) or drops (scatters) only where an index can leave its array,
  counting each case in ``LOWERING_STATS``.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

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
    nest_loops,
    walk,
)

# Shared accumulate-op semantics: neutral elements, reducers and combiners.
# The nest kernel's plain version and its Triton generator import these so
# every lowering agrees when an accumulate op is added.
_ACC_INIT = {"+": 0.0, "*": 1.0, "max": -np.inf, "min": np.inf}


def _reduce(acc: str, vals: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Reduce ``vals`` over ``dims`` with the accumulate op ``acc``."""
    dims = tuple(dims)
    if acc == "+":
        return vals.sum(dim=dims)
    if acc == "max":
        return vals.amax(dim=dims)
    if acc == "min":
        return vals.amin(dim=dims)
    if acc == "*":  # torch.prod takes one dim at a time
        for d in sorted(dims, reverse=True):
            vals = vals.prod(dim=d)
        return vals
    raise ValueError(acc)


def _combine(acc: str, a, b):
    """Fold ``b`` into ``a`` with the accumulate op ``acc``."""
    if acc == "+":
        return a + b
    if acc == "*":
        return a * b
    if acc == "max":
        return torch.maximum(a, b)
    if acc == "min":
        return torch.minimum(a, b)
    raise ValueError(acc)


# ---------------------------------------------------------------------------
# Oracle: literal numpy interpreter
# ---------------------------------------------------------------------------
def execute_numpy(program: Program, inputs: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Interpret ``program`` literally in float64 numpy (the semantics oracle).

    Loops run point-by-point in authored order, so any transformed program
    whose outputs ``np.array_equal`` this one is bit-identical, not merely
    close.  Returns the full array environment (inputs copied, temps zeroed).
    """
    env = {
        a.name: (
            np.zeros(a.shape, dtype=np.float64)
            if a.name in program.temps
            else np.array(inputs[a.name], dtype=np.float64, copy=True)
        )
        for a in program.arrays
    }

    def eval_aff(a: Affine, it_env: dict[str, int]) -> int:
        """Evaluate an affine index expression under the iterator bindings."""
        return a.const + sum(c * it_env[k] for k, c in a.coeffs)

    def run(node: Node, it_env: dict[str, int]) -> None:
        """Execute one loop/computation node under the iterator bindings."""
        if isinstance(node, Computation):
            if any(eval_aff(g, it_env) < 0 for g in node.guards):
                return
            vals = []
            for r in node.reads:
                ix = tuple(eval_aff(e, it_env) for e in r.index)
                vals.append(env[r.array][ix] if ix else env[r.array][()])
            out = node.expr(*vals)
            wix = tuple(eval_aff(e, it_env) for e in node.write.index)
            tgt = env[node.write.array]
            if node.accumulate is None:
                tgt[wix] = out
            elif node.accumulate == "+":
                tgt[wix] += out
            elif node.accumulate == "*":
                tgt[wix] *= out
            elif node.accumulate == "max":
                tgt[wix] = max(tgt[wix], out)
            elif node.accumulate == "min":
                tgt[wix] = min(tgt[wix], out)
            else:
                raise ValueError(node.accumulate)
        else:
            for v in range(node.start, node.stop, node.step):
                it_env[node.iterator] = v
                for child in node.body:
                    run(child, it_env)
            it_env.pop(node.iterator, None)

    for n in program.body:
        run(n, {})
    return env


# ---------------------------------------------------------------------------
# torch backend
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Schedule:
    """Scheduling decisions for ``compile_torch`` (one per top-level nest).

    ``pallas_gemm`` routes the BLAS idiom to the CUDA GEMM kernel;
    ``pallas_nest`` / ``pallas_reduce`` route whole canonical nests to the
    generated Triton nest kernel (fully parallel nests / associative
    reductions), with ``nest_tile`` and ``unroll`` from the recipe.  The names
    are the reference's, since recipes keep their database kinds.  A nest
    outside the tiled class goes to the generic lowering by a counted planner
    decision.  ``scan`` selects the per-step row-view lowering of carried
    loops (canonical mode only).

    ``shard_axis`` opts the nest into the mesh partitioner
    (``repro_torch.core.partition``): when ``compile_sharded`` runs over a
    mesh axis of that name, the planner may shard the nest's outermost
    parallel iterator across it (None keeps the nest replicated).  The flag
    is inert under plain ``compile_torch``.
    """

    mode: str = "canonical"  # 'as_written' | 'canonical'
    use_idioms: bool = True  # BLAS-class dispatch (einsum / CUDA GEMM)
    vec_budget: int = 1 << 22  # max materialized elements per computation
    pallas_gemm: bool = False  # route the GEMM idiom to the CUDA GEMM
    pallas_nest: bool = False  # Triton nest kernel for parallel nests
    pallas_reduce: bool = False  # Triton nest kernel for reduction nests
    nest_tile: tuple[int, ...] | None = None  # trailing-axis tiles (+red last)
    unroll: int = 1  # in-kernel reduction unroll factor
    scan: bool = True  # row-view recurrences (canonical mode)
    shard_axis: str | None = None  # mesh axis for the partition planner


# Lowering counters (tests and the chip smoke read which path ran).
LOWERING_STATS = {"scan": 0, "fori": 0, "clamped_gathers": 0, "dropped_scatters": 0}

# Kernel recipes the planner or the contraction classifier sent to torch,
# by reason.  Decisions are made before any launch; nothing here follows a
# failed kernel.
ROUTED: dict[str, int] = {}


def route(reason: str) -> None:
    """Count one kernel recipe sent to the torch lowering, with its reason."""
    ROUTED[reason] = ROUTED.get(reason, 0) + 1


@dataclass
class _VecAxis:
    iterator: str
    start: int
    stop: int
    step: int

    @property
    def trip(self) -> int:
        return max(0, (self.stop - self.start + self.step - 1) // self.step)

    @property
    def last(self) -> int:
        return self.start + self.step * (self.trip - 1)


class Unsupported(Exception):
    """A nest shape a structured lowering cannot express."""


def _written_arrays(node: Node) -> list[str]:
    if isinstance(node, Computation):
        return [node.write.array]
    out: list[str] = []
    for _, c in walk(node):
        if c.write.array not in out:
            out.append(c.write.array)
    return out


def _is_multiplicative(expr: Callable, n_reads: int) -> float | None:
    """Probe: does ``expr(*xs) == c * prod(xs)``? Return c, else None.

    Memoized per ``expr`` object (weakly, so cached programs don't leak)."""
    try:
        per_expr = _MULT_MEMO.setdefault(expr, {})
    except TypeError:  # not weakref-able (e.g. some builtins/partials)
        return _is_multiplicative_probe(expr, n_reads)
    if n_reads not in per_expr:
        per_expr[n_reads] = _is_multiplicative_probe(expr, n_reads)
    return per_expr[n_reads]


_MULT_MEMO: "weakref.WeakKeyDictionary[Callable, dict[int, float | None]]" = (
    weakref.WeakKeyDictionary()
)


def _is_multiplicative_probe(expr: Callable, n_reads: int) -> float | None:
    if n_reads == 0:
        return None
    rng = np.random.default_rng(0)
    try:
        c = float(expr(*([np.float64(1.0)] * n_reads)))
    except Exception:
        return None
    if not np.isfinite(c) or c == 0.0:
        return None
    for _ in range(3):
        xs = rng.uniform(0.5, 2.0, size=n_reads)
        try:
            got = float(expr(*[np.float64(x) for x in xs]))
        except Exception:
            return None
        want = c * float(np.prod(xs))
        if not np.isclose(got, want, rtol=1e-10, atol=1e-12):
            return None
    return c


def _single_iter_dims(a: Access) -> list[str] | None:
    """If every dim of ``a`` is exactly one iterator (coeff 1, const 0), return
    the iterator per dim; else None."""
    out = []
    for ix in a.index:
        if ix.const != 0 or len(ix.coeffs) != 1 or ix.coeffs[0][1] != 1:
            return None
        out.append(ix.coeffs[0][0])
    return out


def _offset_iter_dims(a: Access) -> list[tuple[str, int]] | None:
    """Like ``_single_iter_dims`` but tolerating constant offsets: per dim,
    ``(iterator, const)`` when the subscript is ``iterator + const`` (coeff 1);
    None when any dim is not of that shape."""
    out = []
    for ix in a.index:
        if len(ix.coeffs) != 1 or ix.coeffs[0][1] != 1:
            return None
        out.append((ix.coeffs[0][0], ix.const))
    return out


class _NestEmitter:
    """Lowers one top-level nest to torch; planned once, run per call."""

    def __init__(self, program: Program, schedule: Schedule, nest: Node):
        self.p = program
        self.s = schedule
        self.nest = nest
        self.kernel = None
        if schedule.pallas_nest or schedule.pallas_reduce:
            from ..kernels.nest_kernel import plan_nest

            try:
                self.kernel = plan_nest(program, nest, schedule)
            except Unsupported as e:  # outside the tiled class: planner decision
                route(f"nest: {e}")
        self.vec_plan = self.plan(nest) if self.kernel is None else {}
        self._scan_memo: dict[int, Any] = {}

    # -- planning -----------------------------------------------------------
    def plan(self, nest: Node) -> dict[str, bool]:
        """iterator -> vectorizable? (plus budget-driven demotion).

        Legality is *per loop over its own subtree*: a loop may be
        materialized as an array axis iff no dependence among the
        computations it encloses is carried by its iterator.
        """
        if isinstance(nest, Computation):
            return {}
        iterators = list(loop_iterators(nest))
        legal: dict[str, bool] = {}

        def visit(n: Node) -> None:
            if isinstance(n, Computation):
                return
            comps = nest_computations(n)
            vecs = nest_direction_vectors([n.iterator], {n.iterator: n.trip_count}, comps)
            legal[n.iterator] = all(v.directions[0] == EQ for v in vecs)
            for b in n.body:
                visit(b)

        visit(nest)
        if self.s.mode == "canonical" and not all(legal.values()) \
                and _conflict_free(self.p, nest):
            legal = dict.fromkeys(legal, True)
        if self.s.mode == "as_written":
            inner: set[str] = set()
            for loops, _ in walk(nest):
                if loops:
                    inner.add(loops[-1].iterator)
            return {it: (legal[it] and it in inner) for it in iterators}
        vec = {it: legal[it] for it in iterators}
        for loops, comp in walk(nest):
            used = [l for l in loops if vec.get(l.iterator)]
            prod = math.prod(max(1, l.trip_count) for l in used)
            for l in used:  # outermost first
                if prod <= self.s.vec_budget:
                    break
                vec[l.iterator] = False
                prod //= max(1, l.trip_count)
        return vec

    # -- emission -----------------------------------------------------------
    def run(self, env: dict[str, torch.Tensor]) -> None:
        """Execute the nest, updating ``env``'s tensors in place."""
        if self.kernel is not None:
            from ..kernels.nest_kernel import run_nest

            run_nest(self.kernel, env)
            return
        self._emit(self.nest, env, {}, [])

    def _emit(self, node: Node, env, seq_env: dict[str, int], vec_axes: list[_VecAxis]) -> None:
        if isinstance(node, Computation):
            self._emit_comp(node, env, seq_env, vec_axes)
            return
        if self.vec_plan.get(node.iterator, False):
            vec2 = vec_axes + [_VecAxis(node.iterator, node.start, node.stop, node.step)]
            for child in node.body:
                self._emit(child, env, seq_env, vec2)
            return
        if node.trip_count <= 0:
            return
        if self.s.mode == "canonical" and self.s.scan:
            if self._try_scan_loop(node, env, seq_env, vec_axes):
                LOWERING_STATS["scan"] += 1
                return
        LOWERING_STATS["fori"] += 1
        s2 = dict(seq_env)
        for k in range(node.trip_count):
            s2[node.iterator] = node.start + k * node.step
            for child in node.body:
                self._emit(child, env, s2, vec_axes)

    # -- row-view lowering of carried loops ------------------------------------
    def _scan_sliceable(self, node: Loop) -> tuple[dict[str, int], set[str]] | None:
        """Classify the arrays of a sequential loop's subtree.

        Returns ``(written_lookback, readonly)`` where ``written_lookback``
        maps each *written* array whose every access subscripts the leading
        axis with exactly ``t + const`` (write const 0, read consts <= 0) to
        its maximum lookback depth, and ``readonly`` holds read-only arrays
        accessed only at ``t`` itself.  None when no written array qualifies.
        """
        t = node.iterator
        status: dict[str, dict] = {}
        for _, c in walk(node):
            for a, is_w in [(c.write, True)] + [(r, False) for r in c.reads]:
                rec = status.setdefault(a.array, {"w": [], "r": [], "bad": False})
                ix0 = a.index[0] if a.index else None
                uses_t = any(ix.coeff(t) != 0 for ix in a.index)
                if ix0 is not None and ix0.coeffs == ((t, 1),) and not any(
                    ix.coeff(t) != 0 for ix in a.index[1:]
                ):
                    (rec["w"] if is_w else rec["r"]).append(ix0.const)
                elif uses_t:
                    rec["bad"] = True
                else:
                    rec.setdefault("plain", True)  # t-independent access
        written_lb: dict[str, int] = {}
        readonly: set[str] = set()
        for name, rec in status.items():
            if rec["bad"] or rec.get("plain"):
                continue
            if rec["w"]:
                if all(c == 0 for c in rec["w"]) and all(c <= 0 for c in rec["r"]):
                    written_lb[name] = max([0] + [-c for c in rec["r"]])
            elif rec["r"] and all(c == 0 for c in rec["r"]):
                readonly.add(name)
        if not written_lb:
            return None
        return written_lb, readonly

    def _scan_children(self, node: Loop):
        """(written_lookback, readonly, rewritten children) for ``node``, or
        None; memoized per loop since it depends on structure only."""
        key = id(node)
        if key in self._scan_memo:
            return self._scan_memo[key]
        cls = self._scan_sliceable(node)
        out = None
        if cls is not None:
            written_lb, readonly = cls
            sliceable = set(written_lb) | readonly

            def rw_access(a: Access) -> Access:
                if a.array not in sliceable:
                    return a
                c = a.index[0].const
                nm = a.array if c == 0 else _lag_name(a.array, -c)
                return Access(nm, a.index[1:])

            def rw(nd: Node) -> Node:
                if isinstance(nd, Computation):
                    return dc_replace(nd, write=rw_access(nd.write),
                                      reads=tuple(rw_access(r) for r in nd.reads))
                return dc_replace(nd, body=tuple(rw(b) for b in nd.body))

            out = (written_lb, readonly, tuple(rw(ch) for ch in node.body))
        self._scan_memo[key] = out
        return out

    def _try_scan_loop(self, node: Loop, env, seq_env, vec_axes) -> bool:
        if node.step != 1:
            return False
        memo = self._scan_children(node)
        if memo is None:
            return False
        written_lb, readonly, children = memo
        t, start, n = node.iterator, node.start, node.trip_count
        for name in list(written_lb) + sorted(readonly):
            arr = env[name]
            if arr.ndim == 0 or start + n > arr.shape[0]:
                return False  # leading axis does not cover the loop range
        sliceable = sorted(set(written_lb) | readonly)
        # Each step binds row views: writes land in the full arrays directly,
        # and a lag-d read sees row t-d, which is what the reference's
        # carried lag slabs hold (rows before ``start`` keep their content,
        # indexed modulo the extent like the reference's initial lags).
        inner = dict(env)
        s2 = dict(seq_env)
        for k in range(n):
            tt = start + k
            for a in sliceable:
                inner[a] = env[a][tt]
            for a, lb in written_lb.items():
                for d in range(1, lb + 1):
                    inner[_lag_name(a, d)] = env[a][(tt - d) % env[a].shape[0]]
            s2[t] = tt
            for ch in children:
                self._emit(ch, inner, s2, vec_axes)
        return True

    # -- computation emission -----------------------------------------------
    def _axes_for(self, comp: Computation, vec_axes: list[_VecAxis]) -> list[_VecAxis]:
        used = set(comp.iterators())
        return [a for a in vec_axes if a.iterator in used]

    def _iter_value(self, it: str, axes: list[_VecAxis], seq_env: dict[str, int], device):
        for pos, a in enumerate(axes):
            if a.iterator == it:
                r = torch.arange(a.start, a.start + a.step * a.trip, a.step,
                                 dtype=torch.int64, device=device)
                shape = [1] * len(axes)
                shape[pos] = a.trip
                return r.reshape(shape)
        if it in seq_env:
            return seq_env[it]
        raise Unsupported(f"iterator {it} not bound")

    def _eval_affine(self, e: Affine, axes, seq_env, device):
        val = e.const
        for it, c in e.coeffs:
            val = val + c * self._iter_value(it, axes, seq_env, device)
        return val

    @staticmethod
    def _affine_range(e: Affine, axes, seq_env) -> tuple[int, int]:
        """Static [lo, hi] of an affine index over the vectorized axes (the
        sequential iterators are bound to Python ints)."""
        lo = hi = e.const
        ax_of = {a.iterator: a for a in axes}
        for it, c in e.coeffs:
            a = ax_of.get(it)
            if a is None:
                lo += c * seq_env[it]
                hi += c * seq_env[it]
            else:
                v0, v1 = c * a.start, c * a.last
                lo += min(v0, v1)
                hi += max(v0, v1)
        return lo, hi

    def _fast_read(self, a: Access, arr: torch.Tensor, axes: list[_VecAxis]):
        """Direct (sliced/permuted) view when every dim of ``a`` is a distinct
        vectorized axis up to a constant offset — no index grids, no gather."""
        its_c = _offset_iter_dims(a)
        if its_c is None or len(its_c) != arr.ndim:
            return None
        its = [it for it, _ in its_c]
        if len(set(its)) != len(its):
            return None
        axis_of = {ax.iterator: k for k, ax in enumerate(axes)}
        if not all(it in axis_of for it in its):
            return None
        sl = []
        for d, (it, c) in enumerate(its_c):
            ax = axes[axis_of[it]]
            start = ax.start + c
            if ax.step != 1 or start < 0 or start + ax.trip > arr.shape[d]:
                return None
            sl.append(slice(start, start + ax.trip))
        arr = arr[tuple(sl)]
        order = sorted(range(arr.ndim), key=lambda d: axis_of[its[d]])
        out = arr.permute(order) if order != list(range(arr.ndim)) else arr
        shape = [1] * len(axes)
        for d, it in enumerate(its):
            shape[axis_of[it]] = arr.shape[d]
        return out.reshape(shape)

    def _indices(self, index, arr, axes, seq_env, gather: bool):
        """Per-dim index values (ints or int64 tensors) plus, for scatters,
        the in-bounds mask (None when every index provably stays inside)."""
        idx, valid = [], None
        for d, ix in enumerate(index):
            v = self._eval_affine(ix, axes, seq_env, arr.device)
            lo, hi = self._affine_range(ix, axes, seq_env)
            size = arr.shape[d]
            if lo < 0 or hi >= size:
                if gather:  # JAX clamps out-of-range gathers
                    LOWERING_STATS["clamped_gathers"] += 1
                    v = min(max(v, 0), size - 1) if isinstance(v, int) else v.clamp(0, size - 1)
                else:  # JAX drops out-of-range scatters
                    LOWERING_STATS["dropped_scatters"] += 1
                    ok = (v >= 0) & (v < size)
                    if isinstance(ok, bool):
                        ok = torch.tensor(ok, device=arr.device)
                    valid = ok if valid is None else valid & ok
            idx.append(v)
        return idx, valid

    def _gather(self, a: Access, env, axes, seq_env):
        arr = env[a.array]
        if not a.index:
            return arr
        fast = self._fast_read(a, arr, axes)
        if fast is not None:
            return fast
        idx, _ = self._indices(a.index, arr, axes, seq_env, gather=True)
        if all(isinstance(i, int) for i in idx):
            return arr[tuple(idx)]
        return arr[_broadcast_index(idx, arr.device)]

    def _emit_comp(self, comp: Computation, env, seq_env, vec_axes) -> None:
        axes = self._axes_for(comp, vec_axes)
        if self.s.use_idioms and self._try_einsum(comp, env, seq_env, axes):
            return
        if self.s.pallas_gemm:  # the GEMM recipe's computation runs generic
            route("einsum2: not a contraction over full-range vectorized axes")
        arr = env[comp.write.array]
        dev = arr.device
        full_shape = tuple(a.trip for a in axes)

        mask = None
        for g in comp.guards:
            gv = self._eval_affine(g, axes, seq_env, dev)
            if isinstance(gv, int):
                if gv < 0:
                    return  # guard false at this sequential point: no effect
                continue
            m = (gv >= 0).broadcast_to(full_shape)
            mask = m if mask is None else (mask & m)

        rvals = [self._gather(r, env, axes, seq_env) for r in comp.reads]
        vals = comp.expr(*rvals)
        if any(vals is r for r in rvals):
            vals = vals.clone()  # a bare read aliases the array it may overwrite
        vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
        vals = vals.broadcast_to(torch.broadcast_shapes(vals.shape, full_shape))

        w_its = set(it for ix in comp.write.index for it in ix.iterators())
        keep = [k for k, a in enumerate(axes) if a.iterator in w_its]
        red = [k for k, a in enumerate(axes) if a.iterator not in w_its]
        acc = comp.accumulate
        if red and acc is None:
            raise Unsupported(f"{comp.name}: assignment under reduction axes")
        if mask is not None and acc is not None:
            vals = torch.where(mask, vals, _ACC_INIT[acc])
            mask = None  # folded into neutral fills
        if red:
            vals = _reduce(acc, vals, red)
        kept_axes = [axes[k] for k in keep]

        if not comp.write.index:  # scalar (0-d) target
            _write_region(arr, vals, mask, acc)
            return

        fast = self._fast_write(comp, kept_axes, arr)
        if fast is not None:
            perm, los, full = fast
            ident = tuple(range(vals.ndim))
            vt = vals.permute(perm) if perm != ident else vals
            mt = None
            if mask is not None and acc is None:
                # set-writes have no reduction axes, so mask is over kept axes
                mt = mask.permute(perm) if perm != ident else mask
            region = arr if full else arr[tuple(
                slice(lo, lo + kept_axes[p].trip) for lo, p in zip(los, perm))]
            _write_region(region, vt, mt, acc)
            return

        widx, valid = self._indices(comp.write.index, arr, kept_axes, seq_env, gather=False)
        if all(isinstance(i, int) for i in widx):
            if valid is None or bool(valid):
                _write_region(arr[tuple(widx)], vals, mask, acc)
            return
        kshape = tuple(a.trip for a in kept_axes)
        widx = [w.broadcast_to(kshape) for w in _broadcast_index(widx, dev)]
        vals = vals.broadcast_to(kshape)
        if mask is not None:
            mask = mask.broadcast_to(kshape)
        if valid is not None:
            valid = valid.broadcast_to(kshape)
            widx = [w[valid] for w in widx]
            vals = vals[valid]
            mask = mask[valid] if mask is not None else None
        widx = tuple(widx)
        if acc is None:
            if mask is not None:
                vals = torch.where(mask, vals, arr[widx])
            arr.index_put_(widx, vals)
        elif acc == "+":
            arr.index_put_(widx, vals, accumulate=True)
        else:
            lin = torch.zeros_like(widx[0])
            for w, st in zip(widx, arr.stride()):
                lin = lin + w * st
            red_op = {"*": "prod", "max": "amax", "min": "amin"}[acc]
            arr.view(-1).scatter_reduce_(0, lin.reshape(-1), vals.reshape(-1), red_op)

    def _fast_write(self, comp, kept_axes, arr):
        """Return ``(perm, origins, full_cover)`` when the write map is a
        permutation of the kept vectorized axes addressing a contiguous
        in-bounds region (stencil interiors update a slice view in place)."""
        its_c = _offset_iter_dims(comp.write)
        if its_c is None or len(its_c) != arr.ndim:
            return None
        its = [it for it, _ in its_c]
        axis_of = {a.iterator: k for k, a in enumerate(kept_axes)}
        if set(its) != set(axis_of) or len(set(its)) != len(its):
            return None
        los, full = [], True
        for d, (it, c) in enumerate(its_c):
            a = kept_axes[axis_of[it]]
            lo = a.start + c
            if a.step != 1 or lo < 0 or lo + a.trip > arr.shape[d]:
                return None
            los.append(lo)
            full = full and lo == 0 and a.trip == arr.shape[d]
        return tuple(axis_of[it] for it in its), tuple(los), full

    # -- BLAS idiom: einsum / CUDA GEMM ----------------------------------------
    def _try_einsum(self, comp, env, seq_env, axes) -> bool:
        if comp.accumulate != "+" or comp.guards or len(comp.reads) < 1:
            return False
        c = _is_multiplicative(comp.expr, len(comp.reads))
        if c is None:
            return False
        ax_of = {a.iterator: a for a in axes}
        # every iterator of the computation must be a vectorized full-range axis
        for it in comp.iterators():
            a = ax_of.get(it)
            if a is None or a.start != 0 or a.step != 1:
                return False

        def classify(a: Access):
            letters, slicers = [], []
            arr = env[a.array]
            for d, ix in enumerate(a.index):
                its = ix.iterators()
                if len(its) == 1 and ix.const == 0 and ix.coeff(its[0]) == 1 and its[0] in ax_of:
                    if ax_of[its[0]].trip != arr.shape[d]:
                        return None
                    letters.append(its[0])
                    slicers.append(None)
                elif not its or all(it in seq_env for it in its):
                    v = ix.const + sum(k * seq_env[it] for it, k in ix.coeffs)
                    if not 0 <= v < arr.shape[d]:
                        return None  # out of range: the generic path clamps
                    slicers.append(v)
                    letters.append(None)
                else:
                    return None
            return letters, slicers

        w = classify(comp.write)
        if w is None or any(l is None for l in w[0]):
            return False
        rs = [classify(r) for r in comp.reads]
        if any(r is None for r in rs):
            return False

        sym: dict[str, str] = {}

        def letter(it: str) -> str:
            if it not in sym:
                sym[it] = "abcdefghijklmnopqrstuvwxyz"[len(sym)]
            return sym[it]

        operands, subs = [], []
        for (letters, slicers), acc_r in zip(rs, comp.reads):
            arr = env[acc_r.array]
            for d in range(len(letters) - 1, -1, -1):
                if letters[d] is None:
                    arr = arr.select(d, slicers[d])
            operands.append(arr)
            subs.append("".join(letter(l) for l in letters if l is not None))
        out_sub = "".join(letter(l) for l in w[0])
        for l in out_sub:
            if not any(l in s for s in subs):
                return False  # output iterator never read: einsum can't broadcast it
        arr = env[comp.write.array]
        if tuple(ax_of[l].trip for l in w[0]) != tuple(arr.shape):
            return False  # partial-cover writes take the generic path
        contrib = None
        if self.s.pallas_gemm:
            from ..kernels import ops as kops

            reason = ("operand count is not 2" if len(operands) != 2
                      else kops.einsum2_reject_reason(subs[0], subs[1], out_sub))
            if reason is None:
                contrib = kops.einsum2(subs[0], subs[1], out_sub, operands[0], operands[1])
            else:  # classifier decision, made before any launch
                route(f"einsum2: {reason}")
        if contrib is None:
            contrib = torch.einsum(",".join(subs) + "->" + out_sub, *operands)
        if c != 1.0:
            contrib = contrib * c
        arr.add_(contrib.to(arr.dtype))
        return True


# Largest nest (iteration points) the exact conflict check enumerates.
EXACT_CHECK_POINTS = 1 << 22


def _conflict_free(program: Program, nest: Node) -> bool:
    """Exact test, by enumerating every point, that a perfect nest with one
    assignment has no dependence between distinct points: its write map is
    injective and no point (whose guards hold) reads what another such point
    writes.  Then any execution order gives the sequential result, so every
    loop may be vectorized.  The dependence analysis treats guards and
    coupled subscripts conservatively (correlation's transpose-copy nest
    ``corr[j, i] = corr[i, j] if j > i`` gets '*' on both loops, which would
    run 1.4M points one by one at PolyBench LARGE); this check is exact."""
    loops = nest_loops(nest)
    if not loops or loops[-1].body != tuple(nest_computations(nest)):
        return False
    comps = nest_computations(nest)
    if len(comps) != 1 or comps[0].accumulate is not None:
        return False
    comp = comps[0]
    if any(l.trip_count <= 0 for l in loops) or \
            math.prod(l.trip_count for l in loops) > EXACT_CHECK_POINTS:
        return False
    grids = np.meshgrid(*[np.arange(l.start, l.stop, l.step) for l in loops],
                        indexing="ij", sparse=True)
    env = {l.iterator: g for l, g in zip(loops, grids)}
    full = tuple(l.trip_count for l in loops)

    def value(ix: Affine):
        if not ix.is_affine or any(it not in env for it, _ in ix.coeffs):
            return None
        return np.broadcast_to(ix.const + sum(c * env[it] for it, c in ix.coeffs), full)

    def linear(a: Access):
        """Flat element offsets of an access at every point (None if any
        index is not affine or leaves its array)."""
        shape = program.array(a.array).shape
        lin = np.zeros(full, dtype=np.int64)
        for ix, size, stride in zip(a.index, shape, program.array(a.array).strides):
            v = value(ix)
            if v is None or v.min() < 0 or v.max() >= size:
                return None
            lin = lin + v.astype(np.int64) * stride
        return lin.reshape(-1)

    active = np.ones(full, dtype=bool)
    for g in comp.guards:
        v = value(g)
        if v is None:
            return False
        active &= v >= 0
    active = active.reshape(-1)
    w = linear(comp.write)
    if w is None or np.unique(w).size != w.size:
        return False
    order = np.argsort(w)
    for r in comp.reads:
        if r.array != comp.write.array:
            continue
        rl = linear(r)
        if rl is None:
            return False
        q = np.flatnonzero(active)  # points that run and read
        pos = np.searchsorted(w[order], rl[q]).clip(0, w.size - 1)
        p = order[pos]  # the point writing that element, if any
        hit = (w[p] == rl[q]) & (p != q) & active[p]
        if hit.any():
            return False
    return True


def _lag_name(a: str, d: int) -> str:
    return f"{a}@lag{d}"


def _broadcast_index(idx, device) -> tuple[torch.Tensor, ...]:
    """Ints and int64 tensors -> a tuple of broadcast int64 index tensors."""
    ts = [torch.as_tensor(i, dtype=torch.int64, device=device) for i in idx]
    return tuple(torch.broadcast_tensors(*ts))


def _write_region(region: torch.Tensor, vals: torch.Tensor, mask, acc: str | None) -> None:
    """Store ``vals`` into the view ``region`` in place: assignment keeps the
    old content where ``mask`` is false; accumulates fold into the old
    content (their masks were already folded into neutral fills)."""
    if acc is None:
        new = torch.where(mask, vals, region) if mask is not None else vals
    else:
        new = _combine(acc, region, vals)
    region.copy_(new)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def check_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``; raises when it names a card that is
    not there (the port never carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def compile_torch(
    program: Program,
    per_nest: Schedule | Sequence[Schedule] = Schedule(),
    device: str | torch.device = "cuda",
) -> Callable[[Mapping[str, Any]], dict[str, torch.Tensor]]:
    """Plan every nest now and return fn: {array: value} -> {array: tensor}.

    ``per_nest`` is one ``Schedule`` per top-level nest (the daisy scheduler
    resolves one recipe per canonical nest); a single ``Schedule`` is
    broadcast to every nest.  Inputs (numpy arrays or tensors) are copied to
    contiguous float32 tensors on ``device`` (a transposed or sliced input
    reaches the nest kernels in the row-major layout their launches take);
    temps start as float32 zeros.
    """
    dev = check_device(device)
    if isinstance(per_nest, Schedule):
        schedules: Sequence[Schedule] = (per_nest,) * len(program.body)
    else:
        schedules = tuple(per_nest)
        if len(schedules) != len(program.body):
            raise ValueError(
                f"{program.name}: got {len(schedules)} schedules for "
                f"{len(program.body)} top-level nests"
            )
    emitters = [_NestEmitter(program, s, n) for n, s in zip(program.body, schedules)]

    def fn(inputs: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Run every nest under its schedule; returns the array environment."""
        env = {
            a.name: (
                torch.zeros(a.shape, dtype=torch.float32, device=dev)
                if a.name in program.temps
                else torch.as_tensor(inputs[a.name]).to(
                    device=dev, dtype=torch.float32, copy=True,
                    memory_format=torch.contiguous_format)
            )
            for a in program.arrays
        }
        for em in emitters:
            em.run(env)
        return env

    return fn


def run_torch(
    program: Program,
    inputs: Mapping[str, Any],
    per_nest: Schedule | Sequence[Schedule] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Compile ``program`` with ``compile_torch`` and run it once."""
    sched = per_nest if per_nest is not None else Schedule()
    return compile_torch(program, sched, device=device)(dict(inputs))
