"""K2 + K3: one generated Triton kernel per canonical nest.

Port of ``repro/kernels/nest_kernel.py::emit_nest`` (the grid-tiled Pallas
lowering: ``_KernelBuilder.build``/``_kernel`` for fully parallel nests,
``_emit_reduce`` for reductions).  The planner is ``repro_torch.core.tiling``;
this module turns its ``TilePlan`` and the nest's ``Expr`` trees into Triton
source, one module per distinct source text:

* one program per parallel tile (a 1-D grid, decomposed per axis); every
  axis is a power-of-two block holding its tile, lanes past the tile or the
  loop bound masked;
* every access is a load at its affine offsets (stencil halos read straight
  from the array; lanes outside it read 0, as the reference's zero-padded
  views do) — no padded copies.  Arrays of one declared shape share one set
  of shape and stride parameters (``NestKernel.groups``), checked equal at
  launch;
* K2 (``pallas_nest``): the computations of the nest run in order; a read of
  what an earlier computation wrote at the same index uses the in-register
  value (the reference's ``slab_env``).  Only lanes inside the domain, the
  guards and the array are stored.  The old content of a written array is
  loaded only where the result depends on it (``needs_old``: an accumulate,
  or a guard whose unselected lanes a later computation reads from the
  slab), and a computation that also reads its write index uses that load.
  A nest whose accesses are all the identity over arrays of the domain's
  shape, reads over its leading axes aside (``flat_nest``: a vector over
  the outer axis, read at the flat offset divided by the inner trips), runs,
  on contiguous arrays, over one flattened range, one program a
  ``FLAT_BLOCK``-element block, so a row length that is not a multiple of
  16 elements does not stop 128-bit accesses; every block but the last
  runs an unmasked body.  The other nests (other broadcasts, guards, halos)
  and strided arrays keep the tiled form, every access masked;
* K3 (``pallas_reduce``): one accumulating computation.  The TPU's
  sequential reduction grid axis becomes a loop inside the program over
  reduction tiles, with ``unroll`` chunks per tile combined in order into an
  fp32 accumulator seeded with the neutral element; masked lanes contribute
  the neutral element, and the result is combined with the old output.
  When the parallel tiles alone are too few programs for the card
  (``reduce_splits``: fewer than two per SM, as at every matrix-vector nest
  of PolyBench LARGE, 19-33 programs), the reduction is split, still in one
  launch: a second grid axis takes contiguous ranges of the reduction tiles,
  each program writes its fp32 partial to a workspace the wrapper
  allocates and counts itself in on its parallel tile's arrival counter,
  and the last of a tile's programs to arrive combines the partials in
  split order with the nest's op, then once with the old output, and
  resets the counter.  The counter is the only atomic; no data is combined
  by atomics, so results are bit-identical from run to run.

Extents, loop bounds and strides are runtime arguments; only the block sizes,
the access structure and the expression are baked into the source, so one
compiled kernel serves every problem size with the same canonical structure
(and the normalized B/np variants reuse the A variant's kernels).

Bound: these kernels are memory bound (a few flops per element, except the
CLOUDSC thermodynamics); the least time is the bytes each array is read and
written once over 3.35 TB/s.  K2 reads each input and writes each output
once (no dead reload of old content, no second load of a pointer read and
written); what is left between it and the bound is the launch and, in
the tiled form, the masked accesses.  What held K3 back at the matrix-vector nests was
the launch, not re-reads: one program per parallel tile walked the whole
reduction alone, so 19-33 programs left most of the 132 SMs idle; the split
fills the card.  K3 still reloads the old output and re-reads operands that
do not span the reduction axis once per parallel tile.

``run_nest`` launches the kernel for CUDA tensors and takes ``nest_plain`` —
the same plan evaluated over the whole extent in torch, with the same masks,
neutral elements and final combine — for CPU tensors only.  ``EMITTED``
counts nest runs on the card (one launch per run, split or not), ``SPLIT``
the runs that took the split form, ``FLAT`` the K2 runs that took the
flattened form, and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from ..core.codegen import _ACC_INIT, _combine, _reduce
from ..core.ir import Access, BinOp, Call, Const, Expr, Neg, Node, Program, Read
from ..core.tiling import TilePlan, TilingError, next_pow2, plan_nest_tiling
from .build import generated_module, import_triton
from .runtime import arrival_counters as _counters  # one per parallel tile of a split
from .runtime import on_device, raw_stream, sm_count

EMITTED = {"pallas_nest": 0, "pallas_reduce": 0}
SPLIT = {"pallas_reduce": 0}
FLAT = {"pallas_nest": 0}
PLAIN = {"pallas_nest": 0, "pallas_reduce": 0}

# A reduction nest is split until it launches this many programs per SM.
PROGRAMS_PER_SM = 2
# Pipeline depth of the split form's reduction loop.
SPLIT_STAGES = 3


# K2's flattened form: elements a program takes and its warps, chosen by
# device time at the mini CLOUDSC scheme's nest (137 x 65,536, 6 arrays) on
# an H100 (PERF.md, PR 20): blocks of 1,024 to 4,096 elements and 4 or 8
# warps lay within 3% of each other, this the fastest; a persistent grid of
# 4 programs an SM was 4-8% slower.
FLAT_BLOCK = 1024
FLAT_WARPS = 4

_NEUTRAL_SRC = {"+": "0.0", "*": "1.0", "max": 'float("-inf")', "min": 'float("inf")'}
_COMBINE_SRC = {"+": "({a} + {b})", "*": "({a} * {b})",
                "max": "tl.maximum({a}, {b})", "min": "tl.minimum({a}, {b})"}
_REDUCE_SRC = {"+": "tl.sum({x}, axis={k})", "*": "tl.reduce({x}, {k}, _mul)",
               "max": "tl.max({x}, axis={k})", "min": "tl.min({x}, axis={k})"}


@dataclass(eq=False)
class NestKernel:
    """A planned nest: its tiling, the arrays it touches, and (lazily) its
    generated Triton source and what its launches share."""

    program: Program
    plan: TilePlan
    unroll: int
    arrays: tuple[str, ...]
    # compiled kernels by launch specialization (``_launch``)
    compiled: dict = field(default_factory=dict, repr=False)

    @property
    def kind(self) -> str:
        """The recipe kind this kernel serves."""
        return "pallas_nest" if self.plan.kind == "parallel" else "pallas_reduce"

    @property
    def num_warps(self) -> int:
        return 4 if self.plan.block_elems <= 2048 else 8

    @property
    def par_block_elems(self) -> int:
        """Elements of one program's output block (the parallel blocks)."""
        return math.prod(a.block for a in self.plan.parallel)

    @functools.cached_property
    def programs(self) -> int:
        """Programs of the tiled launch: one per parallel tile."""
        return math.prod(p.n_tiles for p in self.plan.parallel)

    @functools.cached_property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        """Positions in ``arrays`` of the arrays that share one set of shape
        and stride parameters: one group per declared shape."""
        by_shape: dict[tuple[int, ...], list[int]] = {}
        for k, name in enumerate(self.arrays):
            by_shape.setdefault(tuple(self.program.array(name).shape), []).append(k)
        return tuple(tuple(v) for v in by_shape.values())

    @functools.cached_property
    def group_of(self) -> dict[str, int]:
        """Array name -> its parameter group."""
        return {self.arrays[k]: g for g, members in enumerate(self.groups) for k in members}

    @functools.cached_property
    def bounds(self) -> tuple[int, ...]:
        """(start, stop) of every slab axis, flattened: the launch's last
        arguments."""
        return tuple(v for a in self.plan.axes for v in (a.start, a.stop))

    @functools.cached_property
    def flat(self) -> bool:
        """Whether the flattened form applies (``flat_nest``)."""
        return flat_nest(self.program, self.plan)

    @functools.cached_property
    def flat_elems(self) -> int:
        """Elements of the flattened range (every written array's size)."""
        return math.prod(a.trip for a in self.plan.axes)

    @functools.cached_property
    def group_elems(self) -> tuple[int, ...]:
        """Elements of each parameter group's arrays when the flattened form
        applies: the trips of the leading axes they cover."""
        trips = [a.trip for a in self.plan.axes]
        return tuple(math.prod(trips[:len(self.program.array(self.arrays[m[0]]).shape)])
                     for m in self.groups)

    @functools.cached_property
    def source(self) -> str:
        return triton_source(self)

    @functools.cached_property
    def split_source(self) -> str:
        """The split form of a reduction: ``nest_split``."""
        return triton_source(self, split=True)

    @functools.cached_property
    def kernel(self):
        """The generated ``nest_kernel`` (imported once per planned nest)."""
        import_triton()
        return generated_module(self.source, "nest").nest_kernel

    @functools.cached_property
    def split_kernel(self):
        """The generated ``nest_split``."""
        import_triton()
        return generated_module(self.split_source, "nest_split").nest_split


def needs_old(plan: TilePlan, ci: int) -> bool:
    """Whether computation ``ci`` of a parallel nest needs the old content
    of its write array: it accumulates, or it has a guard and the merged
    value on the lanes the guard leaves (the old content) is read from the
    slab by a later computation, directly or as that one's old content.
    Otherwise every lane that is stored or forwarded takes the new value.
    Lanes outside the array are never stored, and the slab forwards the new
    value there, as the reference's zero-padded views do."""
    comp = plan.comps[ci]
    if comp.accumulate is not None:
        return True
    if not comp.guards:
        return False
    key = (comp.write.array, comp.write.index)
    for cj in range(ci + 1, len(plan.comps)):
        later = plan.comps[cj]
        if any((r.array, r.index) == key for r in later.reads):
            return True
        if later.write.array == comp.write.array:
            return needs_old(plan, cj)
    return False


def flat_rank(program: Program, plan: TilePlan, a: Access) -> int | None:
    """The rank ``r`` when access ``a`` is the identity over the first ``r``
    axes of the domain (dimension d subscripted by axis d, offset 0) of an
    array of those axes' shape, else None.  Over a flattened range of the
    whole domain such an array's element is the flat offset divided by the
    trip counts of the other axes."""
    axes = plan.axes
    dims = plan.access_dims(a)
    r = len(dims)
    if not 1 <= r <= len(axes):
        return None
    if tuple(program.array(a.array).shape) != tuple(ax.stop for ax in axes[:r]):
        return None
    if [(d.iterator, d.const) for d in dims] != [(ax.name, 0) for ax in axes[:r]]:
        return None
    return r


def flat_nest(program: Program, plan: TilePlan) -> bool:
    """Whether a parallel nest can run over one flattened range: no guard,
    every axis starting at 0, every write and every read of an array the
    domain's shape the identity access (``flat_rank``), and every other read
    the identity over leading axes (a vector over the outer axis broadcast
    along the inner one, say) — so each written array is covered whole,
    element for element, and a contiguous one is a single range.  A
    pointwise nest: its results do not depend on the blocking."""
    if plan.kind != "parallel" or any(c.guards for c in plan.comps):
        return False
    if any(a.start != 0 for a in plan.axes):
        return False
    n = len(plan.axes)
    for c in plan.comps:
        if flat_rank(program, plan, c.write) != n:
            return False
        if any(flat_rank(program, plan, r) is None for r in c.reads):
            return False
    return True


def reduce_splits(plan: TilePlan, sms: int) -> int:
    """How many contiguous ranges of reduction tiles a reduction nest's
    launch splits into, from its plan and the card's SM count alone: 1 when
    the parallel tiles already give ``PROGRAMS_PER_SM`` programs per SM (or
    there is one reduction tile), else enough ranges of ``split_tiles``
    tiles each to reach that, never an empty one."""
    if plan.kind != "reduce" or plan.reduce_grid is None:
        return 1
    programs = math.prod(p.n_tiles for p in plan.parallel)
    tiles = plan.reduce_grid.n_tiles
    want = PROGRAMS_PER_SM * sms
    if programs >= want or tiles <= 1:
        return 1
    per = tiles // min(tiles, -(-want // programs))
    return -(-tiles // per)


def split_tiles(plan: TilePlan, splits: int) -> int:
    """Reduction tiles per range when the launch splits into ``splits``;
    every one of the ``splits`` ranges is non-empty (for ``reduce_splits``'
    counts, ``cdiv(tiles, split_tiles) == splits``)."""
    return -(-plan.reduce_grid.n_tiles // splits)


@functools.cache
def plan_nest(program: Program, nest: Node, schedule) -> NestKernel:
    """Plan one canonical nest for the nest kernel; raises ``TilingError``
    (an ``Unsupported``) when it is outside the tiled class — including any
    computation whose scalar function is not an ``Expr`` the generator can
    translate."""
    plan = plan_nest_tiling(program, nest, tile=schedule.nest_tile)
    if plan.kind == "reduce" and not schedule.pallas_reduce:
        raise TilingError("reduction nest but pallas_reduce disabled")
    if plan.kind == "parallel" and not schedule.pallas_nest:
        raise TilingError("parallel nest but pallas_nest disabled")
    if plan.kind == "reduce" and not plan.parallel:
        raise TilingError("reduction without a parallel axis")
    for c in plan.comps:
        _check_expr(c.name, c.expr)
    arrays: list[str] = []
    for c in plan.comps:
        for a in (c.write,) + c.reads:
            if a.array not in arrays:
                arrays.append(a.array)
    return NestKernel(program, plan, max(1, int(schedule.unroll)), tuple(arrays))


def _check_expr(name: str, e: Any) -> None:
    if not isinstance(e, Expr):
        raise TilingError(f"{name}: opaque callable (no Expr to generate from)")
    stack = [e]
    while stack:
        n = stack.pop()
        if isinstance(n, Const) and not math.isfinite(n.value):
            raise TilingError(f"{name}: non-finite constant")
        if isinstance(n, Call) and _device_function(n) is None:
            raise TilingError(f"{name}: no device version of {n.fn_name}")
        stack.extend(n.children())


def _device_function(call: Call):
    """(device source, literal keyword values) of a ``Call``'s function, or
    None: a helper offers a device version through a ``device_source``
    attribute defining a ``@triton.jit`` function named like the ``Call``;
    ``functools.partial`` keywords become trailing literal arguments."""
    fn, kw = call.fn, ()
    if isinstance(fn, functools.partial):
        kw = tuple(fn.keywords.values())
        fn = fn.func
    src = getattr(fn, "device_source", None)
    return None if src is None else (src, kw)


def emit_nest(program: Program, nest: Node, env: dict[str, torch.Tensor], schedule) -> None:
    """Plan and run one canonical nest in place (the reference's entry
    point); raises ``TilingError`` when it is outside the tiled class."""
    run_nest(plan_nest(program, nest, schedule), env)


def run_nest(nk: NestKernel, env: dict[str, torch.Tensor]) -> None:
    """Run a planned nest on ``env`` in place: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = env[nk.arrays[0]].device
    if dev.type == "cpu":
        PLAIN[nk.kind] += 1
        nest_plain(nk, env)
    elif dev.type == "cuda":
        nest_launch(nk, env)
    else:
        raise ValueError(f"nest kernel: unsupported device {dev}")


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
def launch_args(nk: NestKernel, env: dict[str, torch.Tensor]) -> tuple[list, torch.device, bool]:
    """(the kernel's runtime arguments, the arrays' device, whether the
    flattened form applies) for ``env``: the arrays, each parameter group's
    shape and strides, then the loop bounds.  Raises ``ValueError`` unless
    every array is float32 on one device and the arrays of each group agree
    in shape and strides.  The flattened form applies to a ``flat`` nest
    whose arrays are contiguous at the declared shape."""
    ts = [env[name] for name in nk.arrays]
    dev = ts[0].device
    for name, t in zip(nk.arrays, ts):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"nest kernel: {name} is {t.dtype} on {t.device}, "
                             f"want float32 on {dev}")
    args: list[Any] = list(ts)
    flat = nk.flat
    for members, elems in zip(nk.groups, nk.group_elems):
        first = ts[members[0]]
        shape, stride = first.shape, first.stride()
        for k in members[1:]:
            if ts[k].shape != shape or ts[k].stride() != stride:
                raise ValueError(
                    f"nest kernel: {nk.arrays[k]} has shape {tuple(ts[k].shape)} and strides "
                    f"{ts[k].stride()}, {nk.arrays[members[0]]} of the same parameter group "
                    f"{tuple(shape)} and {stride}")
        args.extend(shape)
        args.extend(stride)
        flat = flat and first.is_contiguous() and first.numel() == elems
    args.extend(nk.bounds)
    return args, dev, flat


def nest_launch(nk: NestKernel, env: dict[str, torch.Tensor], splits: int | None = None):
    """Launch the generated Triton kernel on ``env``'s CUDA tensors, once:
    ``nest_kernel`` (K2 flattened where ``launch_args`` allows, one program
    a ``FLAT_BLOCK``-element block; tiled otherwise), or for a split
    reduction ``nest_split`` over a workspace of partials.  ``splits`` is
    ``reduce_splits``' count unless given (the card tests and
    ``chip_smoke.py`` name one to hold and time each form).  Returns the
    compiled kernel."""
    args, dev, is_flat = launch_args(nk, env)
    if dev.type != "cuda":
        raise ValueError(f"nest kernel: arrays on {dev}, want cuda")
    if splits is None:
        splits = 1 if nk.kind == "pallas_nest" else reduce_splits(nk.plan, sm_count(dev))
    elif splits < 1 or splits > 1 and (nk.kind != "pallas_reduce"
                                       or splits > nk.plan.reduce_grid.n_tiles):
        raise ValueError(f"nest kernel: {splits} splits of a {nk.kind} nest")
    with on_device(dev):
        if nk.kind == "pallas_nest" and is_flat:
            out = _launch(nk, nk.kernel, (-(-nk.flat_elems // FLAT_BLOCK), 1, 1), args,
                          {"FLAT": True, "BLOCK": FLAT_BLOCK}, {"num_warps": FLAT_WARPS}, dev)
            FLAT["pallas_nest"] += 1
        elif nk.kind == "pallas_nest":
            out = _launch(nk, nk.kernel, (nk.programs, 1, 1), args, {"FLAT": False, "BLOCK": 1},
                          {"num_warps": nk.num_warps}, dev)
        elif splits == 1:
            out = _launch(nk, nk.kernel, (nk.programs, 1, 1), args, {},
                          {"num_warps": nk.num_warps}, dev)
        else:
            ws = torch.empty((splits, nk.programs, nk.par_block_elems), dtype=torch.float32,
                             device=dev)
            args += [ws, _counters(dev, nk.programs), split_tiles(nk.plan, splits)]
            out = _launch(nk, nk.split_kernel, (nk.programs, splits, 1), args, {},
                          {"num_warps": nk.num_warps, "num_stages": SPLIT_STAGES}, dev)
            SPLIT[nk.kind] += 1
    EMITTED[nk.kind] += 1
    return out


def _launch(nk: NestKernel, fn, grid: tuple[int, int, int], args: list, constexprs: dict,
            options: dict, dev: torch.device):
    """Launch the jitted ``fn`` on ``grid``.  Triton's own dispatch works out
    the arguments' specialization (16-byte aligned pointers, integers equal
    to 1 or divisible by 16), compiles or finds the kernel and launches it:
    most of a small nest's host time.  So the compiled kernel it returns is
    kept on ``nk`` under a key that fixes that specialization (each
    pointer's 16-byte alignment and every integer's value) and later
    launched directly, on the current stream.  Launch hooks, where a tool
    added one, go through Triton's dispatch."""
    import triton

    key = (fn.__name__, dev.index, *constexprs.values(), *options.values(),
           *(a.data_ptr() % 16 == 0 if isinstance(a, torch.Tensor) else a for a in args))
    compiled = nk.compiled.get(key)
    hooks = triton.knobs.runtime
    if compiled is None or _hooked(hooks.launch_enter_hook) or _hooked(hooks.launch_exit_hook):
        compiled = nk.compiled[key] = fn[grid](*args, **constexprs, **options)
    else:
        compiled.run(*grid, raw_stream(dev), compiled.function, compiled.packed_metadata, None,
                     None, None, *args, *constexprs.values())
    return compiled


def _hooked(hook) -> bool:
    """Whether a Triton launch hook does anything: a ``HookChain`` with a
    call in it, or (older Triton) any hook that is set."""
    return hook is not None and bool(getattr(hook, "calls", True))


def _expr_lines(e: Expr, read_var, prefix: str) -> tuple[list[str], str]:
    """Triton statements evaluating ``e`` (shared subtrees once) and the
    name or literal of the result; ``read_var(i)`` names ``Read(i)``."""
    lines: list[str] = []
    names: dict[str, str] = {}

    def emit(n: Expr) -> str:
        if isinstance(n, Read):
            return read_var(n.i)
        if isinstance(n, Const):
            return repr(float(n.value))
        key = n.signature()
        if key in names:
            return names[key]
        if isinstance(n, BinOp):
            a, b = emit(n.lhs), emit(n.rhs)
            if n.op in ("add", "sub", "mul", "div"):
                sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[n.op]
                rhs = f"{a} {sym} {b}"
            else:
                rhs = f"tl.{'maximum' if n.op == 'max' else 'minimum'}({a}, {b})"
        elif isinstance(n, Neg):
            rhs = f"-{emit(n.arg)}"
        elif isinstance(n, Call):
            _, kw = _device_function(n)
            args = [emit(a) for a in n.args] + [repr(v) for v in kw]
            rhs = f"{n.fn_name}({', '.join(args)})"
        else:  # pragma: no cover - defensive
            raise TypeError(type(n))
        name = f"{prefix}{len(names)}"
        names[key] = name
        lines.append(f"{name} = {rhs}")
        return name

    return lines, emit(e)


def _helpers(nk: NestKernel) -> list[str]:
    out: list[str] = []
    for c in nk.plan.comps:
        stack = [c.expr]
        while stack:
            n = stack.pop()
            if isinstance(n, Call):
                src = _device_function(n)[0].strip()
                if src not in out:
                    out.append(src)
            stack.extend(n.children())
    return out


def _is_literal(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return True


def triton_source(nk: NestKernel, split: bool = False) -> str:
    """The Triton module text for a planned nest (no triton import needed):
    ``nest_kernel``, or with ``split`` (reductions only) ``nest_split``,
    whose second grid axis takes ranges of ``per`` reduction tiles and
    writes fp32 partials to ``ws``; the last program of a parallel tile to
    arrive (its count in ``cnt``) combines them in split order and then
    with the old output.  A parallel nest's ``nest_kernel`` takes the
    constexprs ``FLAT`` (the flattened form, in ``BLOCK``-element blocks;
    only a ``flat`` nest has it) and ``BLOCK``."""
    plan = nk.plan
    if split and plan.kind != "reduce":
        raise ValueError("only a reduction nest has a split form")
    axes = plan.axes
    n_axes = len(axes)
    n_par = len(plan.parallel)
    pos = {a.name: k for k, a in enumerate(axes)}
    arr_ix = {name: k for k, name in enumerate(nk.arrays)}
    grp = nk.group_of

    params = [f"p{k}" for k in range(len(nk.arrays))]
    for g, members in enumerate(nk.groups):
        rank = len(nk.program.array(nk.arrays[members[0]]).shape)
        params += [f"n{g}_{d}" for d in range(rank)]
        params += [f"s{g}_{d}" for d in range(rank)]
    for k in range(n_axes):
        params += [f"lo{k}", f"hi{k}"]

    decomp: list[str] = []
    for k in range(n_par - 1, -1, -1):  # innermost parallel axis varies fastest
        t = axes[k].tile
        decomp.append(f"nt{k} = tl.cdiv(hi{k} - lo{k}, {t})")
        decomp.append(f"t{k} = pid % nt{k}")
        decomp.append(f"pid = pid // nt{k}")
        decomp.append(f"r{k} = tl.arange(0, {axes[k].block})")
        decomp.append(f"b{k} = lo{k} + t{k} * {t}")
        decomp.append(f"x{k} = b{k} + r{k}")
        decomp.append(f"m{k} = (r{k} < {t}) & (x{k} < hi{k})")
    inner: list[str] = []
    for k in range(n_par, n_axes - (1 if plan.reduce_grid else 0)):  # inner reductions
        inner.append(f"x{k} = lo{k} + tl.arange(0, {axes[k].block})")
        inner.append(f"m{k} = x{k} < hi{k}")

    def expand(k: int, rank: int) -> str:
        """Index pattern placing 1-D axis ``k`` at its slab position."""
        if rank == 1:
            return ""
        return "[" + ", ".join(":" if j == k else "None" for j in range(rank)) + "]"

    def access_src(a: Access, rank: int) -> tuple[str, str | None]:
        """(pointer expression, mask expression or None) of an access."""
        k, g = arr_ix[a.array], grp[a.array]
        terms, masks = [], []
        for d, dm in enumerate(plan.access_dims(a)):
            if dm.iterator is None:
                terms.append(f"{dm.const} * s{g}_{d}")
                continue
            ax = pos[dm.iterator]
            ix = f"(x{ax}{expand(ax, rank)} + {dm.const})" if dm.const else f"x{ax}{expand(ax, rank)}"
            terms.append(f"{ix} * s{g}_{d}")
            masks.append(f"({ix} >= 0) & ({ix} < n{g}_{d})" if dm.const else f"({ix} < n{g}_{d})")
            masks.append(f"m{ax}{expand(ax, rank)}")
        ptr = f"p{k}" + "".join(f" + {t}" for t in terms)
        return ptr, (" & ".join(masks) if masks else None)

    def guard_src(comp, rank: int) -> str | None:
        gs = []
        for g in comp.guards:
            terms = [str(g.const)] + [f"{c} * x{pos[it]}{expand(pos[it], rank)}" for it, c in g.coeffs]
            gs.append(f"({' + '.join(terms)} >= 0)")
        return " & ".join(gs) if gs else None

    def load_src(var: str, ptr: str, mask: str | None) -> str:
        return f"{var} = tl.load({ptr}" + (f", mask={mask}, other=0.0)" if mask else ")")

    def load_lines(comp, loaded: dict, slab: dict, tag: str, access) -> list[str]:
        out = []
        for i, r in enumerate(comp.reads):
            key = (r.array, r.index)
            if r.array in slab and slab[r.array][0] == r.index:
                loaded[(tag, i)] = slab[r.array][1]
                continue
            if key not in loaded:
                var = f"v{len(loaded)}_{tag}"
                out.append(load_src(var, *access(r)))
                loaded[key] = var
            loaded[(tag, i)] = loaded[key]
        return out

    def parallel_body(access, guards: bool, shape: str, sfx: str = "") -> list[str]:
        """The computations in order over one block: ``access(a)`` gives an
        access's (pointer, mask); ``shape`` is the block's shape (a constant
        value is broadcast to it); ``sfx`` keeps the names of two bodies of
        one kernel apart."""
        out: list[str] = []
        slab: dict[str, tuple[tuple, str]] = {}
        loaded: dict = {}
        for ci, comp in enumerate(plan.comps):
            tag = f"c{ci}{sfx}"
            out += load_lines(comp, loaded, slab, tag, access)
            lines, new = _expr_lines(comp.expr, lambda i, tag=tag: loaded[(tag, i)], f"e{ci}{sfx}_")
            out += lines
            wptr, wmask = access(comp.write)
            guard = guard_src(comp, n_axes) if guards else None
            key = (comp.write.array, comp.write.index)
            if needs_old(plan, ci):
                if comp.write.array in slab:  # the merged value of an earlier write
                    old = slab[comp.write.array][1]
                elif key in loaded:  # this computation reads its write index
                    old = loaded[key]
                else:
                    old = f"old{ci}{sfx}"
                    out.append(load_src(old, wptr, wmask))
                if comp.accumulate is not None:
                    new = _COMBINE_SRC[comp.accumulate].format(a=old, b=new)
                if guard:
                    new = f"tl.where({guard}, {new}, {old})"
            elif _is_literal(new):
                new = f"tl.full({shape}, {new}, tl.float32)"
            w = f"w{ci}{sfx}"
            out.append(f"{w} = {wptr}")
            if not new.isidentifier():
                out.append(f"new{ci}{sfx} = {new}")
                new = f"new{ci}{sfx}"
            smask = " & ".join(x for x in (wmask, guard) if x)
            out.append(f"tl.store({w}, {new}" + (f", mask={smask})" if smask else ")"))
            # later reads of this array use the in-register value (the
            # planner rejects reads of it at any other index)
            slab[comp.write.array] = (comp.write.index, new)
        return out

    def indent(lines: list[str], n: int = 1) -> list[str]:
        return ["    " * n + ln for ln in lines]

    extra: list[str] = []
    if plan.kind == "parallel":
        extra = ["FLAT: tl.constexpr", "BLOCK: tl.constexpr"]
        block_shape = "[" + ", ".join(str(a.block) for a in axes) + "]"
        tiled = (["pid = tl.program_id(0)"] + decomp
                 + parallel_body(lambda a: access_src(a, n_axes), True, block_shape))
        if nk.flat:
            # one program a block; only the last block of the range is ragged
            g = grp[nk.plan.comps[0].write.array]
            size = " * ".join(f"n{g}_{d}" for d in range(n_axes))
            # a read over the leading r axes: its element is the flat offset
            # over the trips of the other axes
            ranks = {a.array: len(plan.access_dims(a)) for c in plan.comps for a in c.reads}
            outer = sorted({r for r in ranks.values() if r < n_axes})
            quot = [f"q{r} = offs // ({' * '.join(f'n{g}_{d}' for d in range(r, n_axes))})"
                    for r in outer]
            flat_ptr = lambda a: (f"p{arr_ix[a.array]} + "  # noqa: E731
                                  + ("offs" if ranks.get(a.array, n_axes) == n_axes
                                     else f"q{ranks[a.array]}"))
            body = (["if FLAT:"]
                    + indent([f"nflat = {size}",
                              "offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)"] + quot
                             + ["if tl.program_id(0) * BLOCK + BLOCK <= nflat:"]
                             + indent(parallel_body(lambda a: (flat_ptr(a), None), False,
                                                    "[BLOCK]"))
                             + ["else:", "    fm = offs < nflat"]
                             + indent(parallel_body(lambda a: (flat_ptr(a), "fm"), False,
                                                    "[BLOCK]", "_m")))
                    + ["else:"] + indent(tiled))
        else:
            body = tiled
    else:
        body = ["pid = tl.program_id(0)"] + decomp + inner
        comp = plan.comps[0]
        op = comp.accumulate
        red = plan.reduce_grid
        rk = n_axes - 1
        tile_r = red.tile
        u = nk.unroll if tile_r % nk.unroll == 0 else 1
        chunk = tile_r // u
        par_shape = "[" + ", ".join(str(axes[k].block) for k in range(n_par)) + "]"
        init = f"acc = tl.zeros({par_shape}, dtype=tl.float32) + {_NEUTRAL_SRC[op]}"
        loop: list[str] = []
        full_mask = " & ".join(f"m{k}{expand(k, n_axes)}" for k in range(n_axes))
        guard = guard_src(comp, n_axes)
        if guard:
            full_mask += f" & {guard}"
        for c in range(u):
            loop.append(f"r{rk} = tl.arange(0, {next_pow2(chunk)})")
            loop.append(f"x{rk} = lo{rk} + kt * {tile_r} + {c * chunk} + r{rk}")
            loop.append(f"m{rk} = (r{rk} < {chunk}) & (x{rk} < hi{rk})")
            loaded: dict = {}
            tag = f"u{c}"
            loop += load_lines(comp, loaded, {}, tag, lambda a: access_src(a, n_axes))
            lines, val = _expr_lines(comp.expr, lambda i, tag=tag: loaded[(tag, i)], f"e{c}_")
            loop += lines
            loop.append(f"z{c} = tl.where({full_mask}, {val}, {_NEUTRAL_SRC[op]})")
            for k in range(n_axes - 1, n_par - 1, -1):
                loop.append(f"z{c} = " + _REDUCE_SRC[op].format(x=f"z{c}", k=k))
            if c:
                loop.append(f"z0 = " + _COMBINE_SRC[op].format(a="z0", b=f"z{c}"))
        loop.append("acc = " + _COMBINE_SRC[op].format(a="acc", b="z0"))
        loop = indent(loop)
        wptr, wmask = access_src(comp.write, n_par)

        def write(v: str) -> list[str]:
            return [f"w = {wptr}", f"old = tl.load(w, mask={wmask}, other=0.0)",
                    "tl.store(w, " + _COMBINE_SRC[op].format(a="old", b=v) + f", mask={wmask})"]

        tiles = f"nt{rk} = tl.cdiv(hi{rk} - lo{rk}, {tile_r})"
        if not split:
            body += [init, tiles, f"for kt in range(0, nt{rk}):"] + loop + write("acc")
        else:
            # the flat offset of each lane of the output block in one partial
            strides = [math.prod(axes[j].block for j in range(k + 1, n_par)) for k in range(n_par)]
            off = "off = " + " + ".join(f"r{k}{expand(k, n_par)} * {strides[k]}"
                                        for k in range(n_par))
            size = nk.par_block_elems
            splits = "tl.num_programs(1)"
            extra = ["ws", "cnt", "per"]
            # every thread's partial is stored before the counter's release;
            # the last to arrive reads the partials past L1 (".cg")
            body = (["prog = tl.program_id(0)", "pid = prog"] + decomp + inner
                    + [init, tiles, "k0 = tl.program_id(1) * per",
                       f"for kt in range(k0, tl.minimum(k0 + per, nt{rk})):"] + loop
                    + [off, f"part = ws + (tl.program_id(1) * tl.num_programs(0) + prog) * {size}",
                       "tl.store(part + off, acc)",
                       "tl.debug_barrier()",
                       'arrived = tl.atomic_add(cnt + prog, 1, sem="acq_rel")',
                       f"if arrived == {splits} - 1:"]
                    + indent([f'tot = tl.load(ws + prog * {size} + off, cache_modifier=".cg")',
                              f"for s in range(1, {splits}):",
                              f"    z = tl.load(ws + (s * tl.num_programs(0) + prog) * {size} + off, "
                              'cache_modifier=".cg")',
                              "    tot = " + _COMBINE_SRC[op].format(a="tot", b="z")]
                             + write("tot") + ["tl.atomic_xchg(cnt + prog, 0)"]))

    src = ["import triton", "import triton.language as tl", ""]
    src += ["", "@triton.jit", "def _mul(a, b):", "    return a * b", ""]
    for h in _helpers(nk):
        src += ["", h, ""]
    name = "nest_split" if split else "nest_kernel"
    src += ["", "@triton.jit", f"def {name}({', '.join(params + extra)}):"]
    src += indent(body)
    return "\n".join(src) + "\n"


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
def nest_plain(nk: NestKernel, env: dict[str, torch.Tensor]) -> None:
    """The same plan in torch, as one whole-extent tile: masked gathers (0
    outside an array), guard masks, slab forwarding, neutral elements for
    masked reduction lanes and the final combine with the old output."""
    plan = nk.plan
    axes = plan.axes
    n_axes = len(axes)
    dev = env[nk.arrays[0]].device
    iota = []
    for k, a in enumerate(axes):
        shape = [1] * n_axes
        shape[k] = a.trip
        iota.append(torch.arange(a.start, a.stop, device=dev).reshape(shape))
    pos = plan.axis_of

    def index(a: Access, keep: list[int] | None = None):
        """Per-dim index tensors (clamped) and the in-array mask."""
        arr = env[a.array]
        idx, ok = [], None
        for d, dm in enumerate(plan.access_dims(a)):
            if dm.iterator is None:
                v = torch.tensor(dm.const, device=dev)
            else:
                v = iota[pos[dm.iterator]] + dm.const
                if keep is not None:
                    v = v.reshape([v.shape[k] for k in keep])
                inb = (v >= 0) & (v < arr.shape[d])
                ok = inb if ok is None else ok & inb
                v = v.clamp(0, arr.shape[d] - 1)
            idx.append(v)
        return tuple(torch.broadcast_tensors(*idx)) if idx else (), ok

    def gather(a: Access, keep=None):
        idx, ok = index(a, keep)
        vals = env[a.array][idx] if idx else env[a.array]
        return vals if ok is None else torch.where(ok, vals, 0.0)

    def guard_mask(comp):
        m = None
        for g in comp.guards:
            v = g.const
            for it, c in g.coeffs:
                v = v + c * iota[pos[it]]
            m = (v >= 0) if m is None else m & (v >= 0)
        return m

    slab: dict[str, tuple[tuple, torch.Tensor]] = {}
    for comp in plan.comps:
        rvals = [slab[r.array][1] if r.array in slab and slab[r.array][0] == r.index
                 else gather(r) for r in comp.reads]
        val = torch.as_tensor(comp.expr(*rvals), dtype=torch.float32, device=dev)
        mask = guard_mask(comp)
        arr = env[comp.write.array]
        if plan.kind == "parallel":
            old = gather(comp.write)
            new = val if comp.accumulate is None else _combine(comp.accumulate, old, val)
            merged = torch.where(mask, new, old) if mask is not None else new
            idx, ok = index(comp.write)
            merged = merged.broadcast_to(idx[0].shape) if idx else merged
            if ok is not None:
                idx = tuple(i[ok] for i in idx)
                merged_w = merged[ok]
            else:
                merged_w = merged
            arr.index_put_(idx, merged_w.to(arr.dtype))
            slab[comp.write.array] = (comp.write.index, merged)
        else:
            op = comp.accumulate
            full = torch.broadcast_shapes(*(t.shape for t in iota))
            val = val.broadcast_to(torch.broadcast_shapes(val.shape, full))
            if mask is not None:
                val = torch.where(mask, val, _ACC_INIT[op])
            part = _reduce(op, val, range(len(plan.parallel), n_axes))
            keep = list(range(len(plan.parallel)))
            idx, ok = index(comp.write, keep)
            old = env[comp.write.array][idx]
            out = _combine(op, old, part.broadcast_to(old.shape))
            if ok is not None:
                idx = tuple(i[ok] for i in idx)
                out = out[ok]
            arr.index_put_(idx, out.to(arr.dtype))
