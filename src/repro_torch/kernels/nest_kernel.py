"""K2 + K3: one generated Triton kernel per canonical nest.

Port of ``repro/kernels/nest_kernel.py::emit_nest`` (the grid-tiled Pallas
lowering: ``_KernelBuilder.build``/``_kernel`` for fully parallel nests,
``_emit_reduce`` for reductions).  The planner is ``repro_torch.core.tiling``;
this module turns its ``TilePlan`` and the nest's ``Expr`` trees into Triton
source, one module per distinct source text:

* one program per parallel tile (a 1-D grid, decomposed per axis); every
  axis is a power-of-two block holding its tile, lanes past the tile or the
  loop bound masked;
* every access is a masked load at its affine offsets (stencil halos read
  straight from the array; lanes outside it read 0, as the reference's
  zero-padded views do) — no padded copies;
* K2 (``pallas_nest``): the computations of the nest run in order; a read of
  what an earlier computation wrote at the same index uses the in-register
  value (the reference's ``slab_env``).  Guard and bound masks select new
  against old content, and only lanes inside the domain, the guards and the
  array are stored;
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
written once over 3.35 TB/s.  What held K3 back at the matrix-vector nests
was the launch, not re-reads: one program per parallel tile walked the whole
reduction alone, so 19-33 programs left most of the 132 SMs idle; the split
fills the card.  Both forms still reload the old content of every written
array, and K3 re-reads operands that do not span the reduction axis once
per parallel tile.

``run_nest`` launches the kernel for CUDA tensors and takes ``nest_plain`` —
the same plan evaluated over the whole extent in torch, with the same masks,
neutral elements and final combine — for CPU tensors only.  ``EMITTED``
counts nest runs on the card (one launch per run, split or not), ``SPLIT``
the runs that took the split form and ``PLAIN`` the plain-version runs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch

from ..core.codegen import _ACC_INIT, _combine, _reduce
from ..core.ir import Access, BinOp, Call, Const, Expr, Neg, Node, Program, Read
from ..core.tiling import TilePlan, TilingError, next_pow2, plan_nest_tiling
from .build import generated_module, import_triton
from .runtime import arrival_counters as _counters  # one per parallel tile of a split
from .runtime import sm_count

EMITTED = {"pallas_nest": 0, "pallas_reduce": 0}
SPLIT = {"pallas_reduce": 0}
PLAIN = {"pallas_nest": 0, "pallas_reduce": 0}

# A reduction nest is split until it launches this many programs per SM.
PROGRAMS_PER_SM = 2
# Pipeline depth of the split form's reduction loop.
SPLIT_STAGES = 3

_NEUTRAL_SRC = {"+": "0.0", "*": "1.0", "max": 'float("-inf")', "min": 'float("inf")'}
_COMBINE_SRC = {"+": "({a} + {b})", "*": "({a} * {b})",
                "max": "tl.maximum({a}, {b})", "min": "tl.minimum({a}, {b})"}
_REDUCE_SRC = {"+": "tl.sum({x}, axis={k})", "*": "tl.reduce({x}, {k}, _mul)",
               "max": "tl.max({x}, axis={k})", "min": "tl.min({x}, axis={k})"}


@dataclass
class NestKernel:
    """A planned nest: its tiling, the arrays it touches, and (lazily) its
    generated Triton source."""

    program: Program
    plan: TilePlan
    unroll: int
    arrays: tuple[str, ...]

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
    def source(self) -> str:
        return triton_source(self)

    @functools.cached_property
    def split_source(self) -> str:
        """The split form of a reduction: ``nest_split``."""
        return triton_source(self, split=True)


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
def nest_launch(nk: NestKernel, env: dict[str, torch.Tensor], splits: int | None = None) -> None:
    """Launch the generated Triton kernel on ``env``'s CUDA tensors, once:
    ``nest_kernel``, or for a split reduction ``nest_split`` over a
    workspace of partials.  ``splits`` is ``reduce_splits``' count unless
    given (the card tests and ``chip_smoke.py`` name one to hold and time
    each form)."""
    import_triton()
    args: list[Any] = []
    dev = None
    for name in nk.arrays:
        t = env[name]
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"nest kernel: {name} is {t.dtype} on {t.device}, "
                             "want float32 on cuda")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"nest kernel: arrays on {dev} and {t.device}")
        args.append(t)
        args.extend(t.shape)
        args.extend(t.stride())
    for ax in nk.plan.axes:
        args.extend((ax.start, ax.stop))
    programs = math.prod(p.n_tiles for p in nk.plan.parallel)
    if splits is None:
        splits = reduce_splits(nk.plan, sm_count(dev))
    elif splits < 1 or splits > 1 and (nk.kind != "pallas_reduce"
                                       or splits > nk.plan.reduce_grid.n_tiles):
        raise ValueError(f"nest kernel: {splits} splits of a {nk.kind} nest")
    with torch.cuda.device(dev):
        if splits == 1:
            generated_module(nk.source, "nest").nest_kernel[(programs,)](
                *args, num_warps=nk.num_warps)
        else:
            mod = generated_module(nk.split_source, "nest_split")
            ws = torch.empty((splits, programs, nk.par_block_elems), dtype=torch.float32,
                             device=dev)
            mod.nest_split[(programs, splits)](
                *args, ws, _counters(dev, programs), split_tiles(nk.plan, splits),
                num_warps=nk.num_warps, num_stages=SPLIT_STAGES)
            SPLIT[nk.kind] += 1
    EMITTED[nk.kind] += 1


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


def triton_source(nk: NestKernel, split: bool = False) -> str:
    """The Triton module text for a planned nest (no triton import needed):
    ``nest_kernel``, or with ``split`` (reductions only) ``nest_split``,
    whose second grid axis takes ranges of ``per`` reduction tiles and
    writes fp32 partials to ``ws``; the last program of a parallel tile to
    arrive (its count in ``cnt``) combines them in split order and then
    with the old output."""
    plan = nk.plan
    if split and plan.kind != "reduce":
        raise ValueError("only a reduction nest has a split form")
    axes = plan.axes
    n_axes = len(axes)
    n_par = len(plan.parallel)
    pos = {a.name: k for k, a in enumerate(axes)}
    arr_ix = {name: k for k, name in enumerate(nk.arrays)}
    shapes = {name: nk.program.array(name).shape for name in nk.arrays}

    params: list[str] = []
    for name in nk.arrays:
        k = arr_ix[name]
        params.append(f"p{k}")
        params += [f"n{k}_{d}" for d in range(len(shapes[name]))]
        params += [f"s{k}_{d}" for d in range(len(shapes[name]))]
    for k in range(n_axes):
        params += [f"lo{k}", f"hi{k}"]

    decomp: list[str] = []
    for k in range(n_par - 1, -1, -1):  # innermost parallel axis varies fastest
        t = axes[k].tile
        decomp.append(f"nt{k} = tl.cdiv(hi{k} - lo{k}, {t})")
        decomp.append(f"t{k} = pid % nt{k}")
        decomp.append(f"pid = pid // nt{k}")
        decomp.append(f"r{k} = tl.arange(0, {axes[k].block})")
        decomp.append(f"x{k} = lo{k} + t{k} * {t} + r{k}")
        decomp.append(f"m{k} = (r{k} < {t}) & (x{k} < hi{k})")
    inner: list[str] = []
    for k in range(n_par, n_axes - (1 if plan.reduce_grid else 0)):  # inner reductions
        inner.append(f"x{k} = lo{k} + tl.arange(0, {axes[k].block})")
        inner.append(f"m{k} = x{k} < hi{k}")
    body: list[str] = ["pid = tl.program_id(0)"] + decomp + inner

    def expand(k: int, rank: int) -> str:
        """Index pattern placing 1-D axis ``k`` at its slab position."""
        if rank == 1:
            return ""
        return "[" + ", ".join(":" if j == k else "None" for j in range(rank)) + "]"

    def access_src(a: Access, rank: int) -> tuple[str, str | None]:
        """(pointer expression, mask expression or None) of an access."""
        k = arr_ix[a.array]
        terms, masks = [], []
        for d, dm in enumerate(plan.access_dims(a)):
            if dm.iterator is None:
                terms.append(f"{dm.const} * s{k}_{d}")
                continue
            ax = pos[dm.iterator]
            ix = f"(x{ax}{expand(ax, rank)} + {dm.const})" if dm.const else f"x{ax}{expand(ax, rank)}"
            terms.append(f"{ix} * s{k}_{d}")
            masks.append(f"({ix} >= 0) & ({ix} < n{k}_{d})" if dm.const else f"({ix} < n{k}_{d})")
            masks.append(f"m{ax}{expand(ax, rank)}")
        ptr = f"p{k}" + "".join(f" + {t}" for t in terms)
        return ptr, (" & ".join(masks) if masks else None)

    def guard_src(comp, rank: int) -> str | None:
        gs = []
        for g in comp.guards:
            terms = [str(g.const)] + [f"{c} * x{pos[it]}{expand(pos[it], rank)}" for it, c in g.coeffs]
            gs.append(f"({' + '.join(terms)} >= 0)")
        return " & ".join(gs) if gs else None

    def load_lines(comp, rank: int, loaded: dict, slab: dict, tag: str) -> list[str]:
        out = []
        for i, r in enumerate(comp.reads):
            key = (r.array, r.index)
            if r.array in slab and slab[r.array][0] == r.index:
                loaded[(tag, i)] = slab[r.array][1]
                continue
            if key not in loaded:
                var = f"v{len(loaded)}_{tag}"
                ptr, mask = access_src(r, rank)
                out.append(f"{var} = tl.load({ptr}" + (f", mask={mask}, other=0.0)" if mask else ")"))
                loaded[key] = var
            loaded[(tag, i)] = loaded[key]
        return out

    if plan.kind == "parallel":
        slab: dict[str, tuple[tuple, str]] = {}
        loaded: dict = {}
        for ci, comp in enumerate(plan.comps):
            tag = f"c{ci}"
            body += load_lines(comp, n_axes, loaded, slab, tag)
            lines, val = _expr_lines(comp.expr, lambda i, tag=tag: loaded[(tag, i)], f"e{ci}_")
            body += lines
            wptr, wmask = access_src(comp.write, n_axes)
            guard = guard_src(comp, n_axes)
            body.append(f"w{ci} = {wptr}")
            body.append(f"old{ci} = tl.load(w{ci}, mask={wmask}, other=0.0)")
            new = val if comp.accumulate is None else _COMBINE_SRC[comp.accumulate].format(
                a=f"old{ci}", b=val)
            sel = " & ".join(x for x in (wmask, guard) if x)
            body.append(f"new{ci} = tl.where({sel}, {new}, old{ci})")
            body.append(f"tl.store(w{ci}, new{ci}, mask={sel})")
            # later reads of this array use the in-register value (the
            # planner rejects reads of it at any other index)
            slab[comp.write.array] = (comp.write.index, f"new{ci}")
    else:
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
            loop += load_lines(comp, n_axes, loaded, {}, tag)
            lines, val = _expr_lines(comp.expr, lambda i, tag=tag: loaded[(tag, i)], f"e{c}_")
            loop += lines
            loop.append(f"z{c} = tl.where({full_mask}, {val}, {_NEUTRAL_SRC[op]})")
            for k in range(n_axes - 1, n_par - 1, -1):
                loop.append(f"z{c} = " + _REDUCE_SRC[op].format(x=f"z{c}", k=k))
            if c:
                loop.append(f"z0 = " + _COMBINE_SRC[op].format(a="z0", b=f"z{c}"))
        loop.append("acc = " + _COMBINE_SRC[op].format(a="acc", b="z0"))
        loop = ["    " + ln for ln in loop]
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
                    + ["    " + ln for ln in
                       [f'tot = tl.load(ws + prog * {size} + off, cache_modifier=".cg")',
                        f"for s in range(1, {splits}):",
                        f"    z = tl.load(ws + (s * tl.num_programs(0) + prog) * {size} + off, "
                        'cache_modifier=".cg")',
                        "    tot = " + _COMBINE_SRC[op].format(a="tot", b="z")]
                       + write("tot") + ["tl.atomic_xchg(cnt + prog, 0)"]])

    src = ["import triton", "import triton.language as tl", ""]
    src += ["", "@triton.jit", "def _mul(a, b):", "    return a * b", ""]
    for h in _helpers(nk):
        src += ["", h, ""]
    name, extra = ("nest_split", ["ws", "cnt", "per"]) if split else ("nest_kernel", [])
    src += ["", "@triton.jit", f"def {name}({', '.join(params + extra)}):"]
    src += ["    " + ln for ln in body]
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
