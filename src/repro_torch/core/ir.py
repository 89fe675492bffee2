"""Affine loop-nest IR — the substrate for a priori loop nest normalization.

Port of ``repro/core/ir.py``: a copy whose fingerprints are byte-identical to
the reference's (tuning-database keys depend on them); only the ``max``/``min``
evaluation of ``Expr`` trees dispatches to torch instead of jax.numpy.

The paper (Trümper et al., CGO'25) defines:
  * Computation — unit of work with exactly one write of a scalar to a container.
  * Loop — iterator, bounds, step, and a body of computations/loops.
  * Loop nest — tree of loops and computations (Fig. 2).

This module is a faithful, symbolic encoding of those definitions.  Index
expressions are affine maps over the enclosing iterators, which is what the
paper's Polly-based lifting produces for the benchmarks it handles; non-affine
accesses are representable (coefficient on the special iterator ``"*"``) and
deliberately block normalization, modeling the paper's lifting failures
(correlation/covariance in §4.1).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

NONAFFINE = "*"  # marker iterator for non-affine index terms


# ---------------------------------------------------------------------------
# Affine expressions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Affine:
    """``sum(coeffs[it] * it) + const`` over iterator names."""

    coeffs: tuple[tuple[str, int], ...] = ()
    const: int = 0

    @staticmethod
    def of(*terms: tuple[str, int] | str, const: int = 0) -> "Affine":
        """Build from ``('i', 2)`` pairs or bare iterator names (coeff 1)."""
        cs: dict[str, int] = {}
        for t in terms:
            name, c = (t, 1) if isinstance(t, str) else t
            cs[name] = cs.get(name, 0) + c
        return Affine(tuple(sorted((k, v) for k, v in cs.items() if v != 0)), const)

    def coeff(self, it: str) -> int:
        """The coefficient of iterator ``it`` (0 when absent)."""
        for k, v in self.coeffs:
            if k == it:
                return v
        return 0

    @property
    def is_affine(self) -> bool:
        """True unless the expression carries the non-affine marker term."""
        return self.coeff(NONAFFINE) == 0

    def iterators(self) -> tuple[str, ...]:
        """The iterator names with nonzero coefficients."""
        return tuple(k for k, _ in self.coeffs if k != NONAFFINE)

    def rename(self, mapping: Mapping[str, str]) -> "Affine":
        """A copy with iterator names substituted via ``mapping``."""
        return Affine(
            tuple(sorted((mapping.get(k, k), v) for k, v in self.coeffs)), self.const
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{v}*{k}" if v != 1 else k for k, v in self.coeffs]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)


def aff(*terms, const: int = 0) -> Affine:
    """Shorthand: aff('i'), aff(('i',2),'j',const=1)."""
    return Affine.of(*terms, const=const)


# ---------------------------------------------------------------------------
# Data containers and accesses
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Array:
    """A data container with a row-major layout (strides derived from shape)."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"

    @property
    def strides(self) -> tuple[int, ...]:
        """Row-major element strides derived from the shape."""
        s = [1] * len(self.shape)
        for d in range(len(self.shape) - 2, -1, -1):
            s[d] = s[d + 1] * self.shape[d + 1]
        return tuple(s)

    @property
    def size(self) -> int:
        """Total element count (1 for scalars)."""
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass(frozen=True)
class Access:
    """An affine access ``array[index_0, ..., index_{r-1}]``."""

    array: str
    index: tuple[Affine, ...]

    @property
    def is_affine(self) -> bool:
        """True when every index expression is affine."""
        return all(ix.is_affine for ix in self.index)

    def iterators(self) -> tuple[str, ...]:
        """Iterators appearing in any index, in first-appearance order."""
        seen: list[str] = []
        for ix in self.index:
            for it in ix.iterators():
                if it not in seen:
                    seen.append(it)
        return tuple(seen)

    def rename(self, mapping: Mapping[str, str]) -> "Access":
        """A copy with iterator names substituted in every index."""
        return Access(self.array, tuple(ix.rename(mapping) for ix in self.index))


def acc(array: str, *index) -> Access:
    """Shorthand: acc('A','i','k'), acc('C','i',aff('j',const=1))."""
    ix = tuple(x if isinstance(x, Affine) else aff(x) for x in index)
    return Access(array, ix)


# ---------------------------------------------------------------------------
# Symbolic scalar expressions
# ---------------------------------------------------------------------------
class Expr:
    """A symbolic scalar expression over a computation's reads tuple.

    Historically ``Computation.expr`` was an opaque Python callable, which the
    pass pipeline could execute but never inspect — every hoistable
    subexpression was recomputed on every iteration because no pass could see
    inside it.  ``Expr`` trees make the scalar math first-class IR:

    * ``Read(i)``  — the value of ``reads[i]`` at the current iteration point,
    * ``Const(v)`` — a compile-time float constant,
    * ``BinOp(op, lhs, rhs)`` — ``add | sub | mul | div | max | min``,
    * ``Neg(arg)`` — unary negation,
    * ``Call(name, fn, args)`` — an opaque scalar function (e.g. the IFS
      thermodynamic functions) applied to sub-expressions; rewrites treat it
      as an atomic, expensive leaf operation.

    Instances are frozen and compare/hash *structurally*, so rewrite passes
    (``repro.core.rewrite``) can detect duplicated subtrees, and the content
    fingerprint is a pure function of the tree (stable across processes).

    Every ``Expr`` is itself callable: ``__call__`` lazily compiles the tree
    via :meth:`to_callable` and evaluates it, so every existing consumer —
    ``execute_numpy``, the JAX lowerings, ``nest_kernel``, the idiom probes —
    keeps treating ``comp.expr`` as a plain scalar function.  Arithmetic
    operators build trees (``Read(0) * 1.5 + Read(1)``), mirroring how the
    front-end builders previously wrote lambdas.
    """

    def __add__(self, other: "Expr | float") -> "Expr":
        """Build ``self + other`` (numbers are wrapped into ``Const``)."""
        return BinOp("add", self, as_expr(other))

    def __radd__(self, other: "Expr | float") -> "Expr":
        """Build ``other + self``."""
        return BinOp("add", as_expr(other), self)

    def __sub__(self, other: "Expr | float") -> "Expr":
        """Build ``self - other``."""
        return BinOp("sub", self, as_expr(other))

    def __rsub__(self, other: "Expr | float") -> "Expr":
        """Build ``other - self``."""
        return BinOp("sub", as_expr(other), self)

    def __mul__(self, other: "Expr | float") -> "Expr":
        """Build ``self * other``."""
        return BinOp("mul", self, as_expr(other))

    def __rmul__(self, other: "Expr | float") -> "Expr":
        """Build ``other * self``."""
        return BinOp("mul", as_expr(other), self)

    def __truediv__(self, other: "Expr | float") -> "Expr":
        """Build ``self / other``."""
        return BinOp("div", self, as_expr(other))

    def __rtruediv__(self, other: "Expr | float") -> "Expr":
        """Build ``other / self``."""
        return BinOp("div", as_expr(other), self)

    def __neg__(self) -> "Expr":
        """Build ``-self``."""
        return Neg(self)

    def __call__(self, *vals: Any) -> Any:
        """Evaluate at concrete read values (compiles once, then caches)."""
        fn = getattr(self, "_fn", None)
        if fn is None:
            fn = self.to_callable()
            object.__setattr__(self, "_fn", fn)
        return fn(*vals)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        """Render the structural signature."""
        return self.signature()

    def signature(self) -> str:
        """Deterministic structural key (used for CSE, dedup, fingerprints)."""
        sig = getattr(self, "_sig", None)
        if sig is None:
            sig = self._signature()
            object.__setattr__(self, "_sig", sig)
        return sig

    def _signature(self) -> str:
        raise NotImplementedError  # pragma: no cover - abstract

    def children(self) -> tuple["Expr", ...]:
        """Direct sub-expressions (empty for ``Read``/``Const`` leaves)."""
        return ()

    def rebuild(self, children: tuple["Expr", ...]) -> "Expr":
        """A structurally-identical node with ``children`` substituted."""
        return self

    def to_callable(self) -> Callable[..., Any]:
        """Synthesize the torch-evaluable scalar function this tree denotes.

        The tree is compiled (once) to a flat sequence of Python statements
        with duplicated subtrees evaluated a single time, so evaluation speed
        matches the hand-written lambdas the front-ends used to build, and
        within-expression common subexpressions are already deduplicated.
        ``max``/``min`` dispatch to numpy for numpy/scalar operands and to
        torch for tensors, like the CLOUDSC helpers.
        """
        lines: list[str] = []
        names: dict[str, str] = {}  # signature -> local name
        env: dict[str, Any] = {"_emax": _eval_max, "_emin": _eval_min}

        def emit(e: "Expr") -> str:
            """Emit one node, reusing the local bound to any repeated subtree."""
            if isinstance(e, Read):
                return f"_v[{e.i}]"
            if isinstance(e, Const):
                return repr(e.value)
            key = e.signature()
            hit = names.get(key)
            if hit is not None:
                return hit
            if isinstance(e, BinOp):
                a, b = emit(e.lhs), emit(e.rhs)
                sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}.get(e.op)
                rhs = f"{a} {sym} {b}" if sym else (
                    f"_emax({a}, {b})" if e.op == "max" else f"_emin({a}, {b})")
            elif isinstance(e, Neg):
                rhs = f"-{emit(e.arg)}"
            elif isinstance(e, Call):
                fname = f"_f{len(env)}"
                env[fname] = e.fn
                rhs = f"{fname}({', '.join(emit(a) for a in e.args)})"
            else:  # pragma: no cover - defensive
                raise TypeError(type(e))
            name = f"_t{len(names)}"
            names[key] = name
            lines.append(f"    {name} = {rhs}")
            return name

        out = emit(self)
        src = "def _expr(*_v):\n" + "\n".join(lines + [f"    return {out}"])
        exec(compile(src, "<repro_torch.Expr>", "exec"), env)
        return env["_expr"]


def as_expr(v: "Expr | float | int") -> "Expr":
    """Coerce a Python number to ``Const``; pass ``Expr`` through."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, np.integer, np.floating)):
        return Const(float(v))
    raise TypeError(f"cannot build Expr from {type(v).__name__}")


@dataclass(frozen=True, repr=False)
class Read(Expr):
    """The value of ``reads[i]`` at the current iteration point."""

    i: int

    def _signature(self) -> str:
        return f"r{self.i}"


@dataclass(frozen=True, repr=False)
class Const(Expr):
    """A compile-time float constant."""

    value: float

    def _signature(self) -> str:
        return repr(self.value)


@dataclass(frozen=True, repr=False)
class BinOp(Expr):
    """A binary operation: ``add | sub | mul | div | max | min``."""

    op: str
    lhs: Expr
    rhs: Expr

    def _signature(self) -> str:
        return f"({self.op} {self.lhs.signature()} {self.rhs.signature()})"

    def children(self) -> tuple[Expr, ...]:
        """The two operands."""
        return (self.lhs, self.rhs)

    def rebuild(self, children: tuple[Expr, ...]) -> Expr:
        """Same op over new operands."""
        return BinOp(self.op, children[0], children[1])


@dataclass(frozen=True, repr=False)
class Neg(Expr):
    """Unary negation."""

    arg: Expr

    def _signature(self) -> str:
        return f"(neg {self.arg.signature()})"

    def children(self) -> tuple[Expr, ...]:
        """The single operand."""
        return (self.arg,)

    def rebuild(self, children: tuple[Expr, ...]) -> Expr:
        """Negation of the new operand."""
        return Neg(children[0])


@dataclass(frozen=True, repr=False)
class Call(Expr):
    """An opaque scalar function applied to sub-expressions.

    Compared/hashed by ``fn_name`` (+ args), so two programs built from the
    same module-level helper (e.g. ``foeewm``) fingerprint identically while
    the callable itself stays out of the structural identity.  Rewrites treat
    a ``Call`` as an expensive atomic operation — prime hoisting material.
    """

    fn_name: str
    fn: Callable[..., Any] = field(compare=False)
    args: tuple[Expr, ...] = ()

    def _signature(self) -> str:
        return f"(call {self.fn_name} {' '.join(a.signature() for a in self.args)})"

    def __hash__(self) -> int:
        """Hash by name + args (``fn`` is identity-excluded, like ``__eq__``)."""
        return hash((self.fn_name, self.args))

    def children(self) -> tuple[Expr, ...]:
        """The argument expressions."""
        return self.args

    def rebuild(self, children: tuple[Expr, ...]) -> Expr:
        """Same function over new arguments."""
        return Call(self.fn_name, self.fn, tuple(children))


def emax(a: "Expr | float", b: "Expr | float") -> Expr:
    """Symbolic elementwise maximum."""
    return BinOp("max", as_expr(a), as_expr(b))


def emin(a: "Expr | float", b: "Expr | float") -> Expr:
    """Symbolic elementwise minimum."""
    return BinOp("min", as_expr(a), as_expr(b))


def _np_like(v: Any) -> bool:
    return isinstance(v, (int, float, np.generic, np.ndarray))


def _eval_max(a: Any, b: Any) -> Any:
    if _np_like(a) and _np_like(b):
        return np.maximum(a, b)
    return _torch_binary(a, b, "maximum")


def _eval_min(a: Any, b: Any) -> Any:
    if _np_like(a) and _np_like(b):
        return np.minimum(a, b)
    return _torch_binary(a, b, "minimum")


def _torch_binary(a: Any, b: Any, op: str) -> Any:
    """``torch.maximum``/``torch.minimum`` with Python/numpy scalars broadcast
    as tensors of the other operand's dtype and device."""
    import torch

    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return getattr(torch, op)(a, b)


def expr_nodes(e: Expr) -> list[Expr]:
    """Unique sub-expressions of ``e`` in post-order (children first).

    Structural duplicates appear once — matching what :meth:`Expr.to_callable`
    actually evaluates — so op counts over this list reflect real work.
    """
    seen: set[str] = set()
    out: list[Expr] = []

    def rec(n: Expr) -> None:
        """Post-order walk, visiting each distinct subtree once."""
        key = n.signature()
        if key in seen:
            return
        seen.add(key)
        for c in n.children():
            rec(c)
        out.append(n)

    rec(e)
    return out


def expr_reads(e: Expr) -> tuple[int, ...]:
    """Sorted unique ``Read`` indices referenced by ``e``."""
    return tuple(sorted({n.i for n in expr_nodes(e) if isinstance(n, Read)}))


def expr_map_reads(e: Expr, mapping: Mapping[int, int]) -> Expr:
    """Rewrite every ``Read(i)`` to ``Read(mapping[i])`` (identity if absent)."""
    if isinstance(e, Read):
        return Read(mapping.get(e.i, e.i))
    kids = e.children()
    if not kids:
        return e
    return e.rebuild(tuple(expr_map_reads(c, mapping) for c in kids))


CALL_COST = 8  # flop surrogate for an opaque Call (transcendental chains)


def expr_ops(e: Expr) -> int:
    """Weighted operation count of the deduplicated expression DAG.

    ``BinOp``/``Neg`` count 1; a ``Call`` counts :data:`CALL_COST` (the IFS
    thermodynamic functions expand to ~10-20 flops including ``exp``).  Used
    by the rewrite passes' cost guards and the flops-before/after stats.
    """
    total = 0
    for n in expr_nodes(e):
        if isinstance(n, (BinOp, Neg)):
            total += 1
        elif isinstance(n, Call):
            total += CALL_COST
    return total


# ---------------------------------------------------------------------------
# Computations and loops
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Computation:
    """One statement: ``write op= expr(*reads)``.

    ``expr`` is a scalar function (torch-evaluable) of the read values — either
    an opaque Python callable, or a symbolic :class:`Expr` tree (itself
    callable) that the rewrite passes can inspect and transform; the IR
    otherwise reasons only about the access structure, exactly like the
    paper's symbolic representation. ``accumulate`` marks reduction writes
    (``'+'``, ``'max'``, ``'min'``, ``'*'``) vs plain assignment (None).

    ``guards`` are affine inequalities ``g(iters) >= 0`` restricting the
    iteration domain — triangular PolyBench domains are represented as a
    rectangular box plus guards (the isl-domain flattened), which keeps loop
    bounds static while preserving semantics.
    """

    name: str
    write: Access
    reads: tuple[Access, ...]
    expr: Callable[..., Any]
    accumulate: str | None = None
    guards: tuple[Affine, ...] = ()

    def accesses(self) -> tuple[Access, ...]:
        """All accesses: the write first, then the reads."""
        return (self.write,) + self.reads

    def iterators(self) -> tuple[str, ...]:
        """Iterators referenced by any access or guard, in appearance order."""
        seen: list[str] = []
        for a in self.accesses():
            for it in a.iterators():
                if it not in seen:
                    seen.append(it)
        for g in self.guards:
            for it in g.iterators():
                if it not in seen:
                    seen.append(it)
        return tuple(seen)

    def rename(self, mapping: Mapping[str, str]) -> "Computation":
        """A copy with iterators substituted in accesses and guards."""
        return replace(
            self,
            write=self.write.rename(mapping),
            reads=tuple(r.rename(mapping) for r in self.reads),
            guards=tuple(g.rename(mapping) for g in self.guards),
        )


@dataclass(frozen=True)
class Loop:
    """``for it in range(start, stop, step): body``  (bounds are static ints)."""

    iterator: str
    stop: int
    start: int = 0
    step: int = 1
    body: tuple["Node", ...] = ()

    @property
    def trip_count(self) -> int:
        """Number of iterations (0 when the range is empty)."""
        return max(0, (self.stop - self.start + self.step - 1) // self.step)

    def rename(self, mapping: Mapping[str, str]) -> "Loop":
        """A copy with the iterator (and body iterators) substituted."""
        return replace(
            self,
            iterator=mapping.get(self.iterator, self.iterator),
            body=tuple(b.rename(mapping) for b in self.body),
        )


Node = Loop | Computation


@dataclass(frozen=True)
class Program:
    """An ordered sequence of loops/computations plus array declarations.

    ``temps`` names scratch containers: they are zero-initialized by the
    runtime rather than supplied as inputs, and normalization (e.g. scalar
    expansion) may freely change their shapes.
    """

    name: str
    arrays: tuple[Array, ...]
    body: tuple[Node, ...]
    temps: tuple[str, ...] = ()

    def array(self, name: str) -> Array:
        """The declared ``Array`` named ``name`` (KeyError when absent)."""
        for a in self.arrays:
            if a.name == name:
                return a
        raise KeyError(name)

    @property
    def array_names(self) -> tuple[str, ...]:
        """All declared array names, in declaration order."""
        return tuple(a.name for a in self.arrays)

    @property
    def input_arrays(self) -> tuple[Array, ...]:
        """The non-temp arrays callers must supply as inputs."""
        return tuple(a for a in self.arrays if a.name not in self.temps)


# ---------------------------------------------------------------------------
# Tree utilities
# ---------------------------------------------------------------------------
def walk(node: Node, prefix: tuple[Loop, ...] = ()) -> Iterable[tuple[tuple[Loop, ...], Computation]]:
    """Yield (enclosing loops, computation) for every computation under node."""
    if isinstance(node, Computation):
        yield prefix, node
    else:
        for child in node.body:
            yield from walk(child, prefix + (node,))


def program_computations(p: Program) -> list[tuple[tuple[Loop, ...], Computation]]:
    """Every (enclosing loops, computation) pair across the whole program."""
    out: list[tuple[tuple[Loop, ...], Computation]] = []
    for n in p.body:
        out.extend(walk(n))
    return out


def loop_iterators(node: Node) -> tuple[str, ...]:
    """In-order iterator names of a nest (paper's loop -> (i_1..i_n) notation)."""
    if isinstance(node, Computation):
        return ()
    its = (node.iterator,)
    for child in node.body:
        for it in loop_iterators(child):
            if it not in its:
                its = its + (it,)
    return its


def is_perfect_nest(node: Node) -> bool:
    """True if node is a chain of single-child loops ending in computations."""
    while isinstance(node, Loop):
        kids = node.body
        if all(isinstance(k, Computation) for k in kids):
            return True
        if len(kids) != 1:
            return False
        node = kids[0]
    return True


def nest_computations(node: Node) -> list[Computation]:
    """All computations under one nest (or the node itself, when bare)."""
    return [c for _, c in walk(node)] if isinstance(node, Loop) else [node]


def nest_loops(node: Node) -> list[Loop]:
    """The chain of loops from the root of a (quasi-)perfect nest."""
    out: list[Loop] = []
    while isinstance(node, Loop):
        out.append(node)
        loops = [k for k in node.body if isinstance(k, Loop)]
        if len(loops) == 1 and len(node.body) == 1:
            node = loops[0]
        else:
            break
    return out


def rename_nest(node: Node, suffix: str) -> Node:
    """Clone a nest with fresh iterator names (paper §2.1: i'_1 = i_1, ...)."""
    its = loop_iterators(node) if isinstance(node, Loop) else ()
    mapping = {it: f"{it}{suffix}" for it in its}
    return node.rename(mapping)


def fingerprint(node: Node) -> str:
    """Structural fingerprint of a nest, invariant to iterator names.

    Canonical iterator names are assigned by in-order traversal position so two
    nests that differ only in naming hash identically — this is the key the
    transfer-tuning database ultimately relies on.
    """
    its = loop_iterators(node) if isinstance(node, Loop) else ()
    mapping = {it: f"t{k}" for k, it in enumerate(its)}

    def fmt_aff(a: Affine) -> str:
        """Render an affine index under canonical iterator names."""
        return repr(a.rename(mapping))

    def fmt_acc(a: Access) -> str:
        """Render one access as ``array[idx,...]``."""
        return f"{a.array}[{','.join(fmt_aff(ix) for ix in a.index)}]"

    def fmt(n: Node) -> str:
        """Render a node (and its subtree) into the fingerprint string."""
        if isinstance(n, Computation):
            rd = ";".join(fmt_acc(r) for r in n.reads)
            gd = ";".join(fmt_aff(g) for g in n.guards)
            return f"C({fmt_acc(n.write)}{n.accumulate or '='}{rd}|{gd})"
        inner = ",".join(fmt(b) for b in n.body)
        return f"L[{mapping.get(n.iterator, n.iterator)}:{n.start}:{n.stop}:{n.step}]({inner})"

    return fmt(node)


def _expr_signature(comp: Computation) -> str:
    """Content signature of a computation's opaque scalar ``expr``.

    The structural fingerprint deliberately ignores ``expr`` (the IR reasons
    about access structure only), but a *compilation* cache must not conflate
    two programs whose nests match structurally while computing different
    scalar functions.  Two complementary captures:

    * for plain Python functions, a hash of the code object (bytecode,
      consts, names) plus closure cell values and defaults — exact for the
      lambdas the front-ends build, including rebuilt-from-source copies;
    * evaluation at fixed probe points spanning sign changes and magnitudes
      past common thresholds, for callables without ``__code__`` (ufuncs,
      partials) and to distinguish equal-bytecode closures whose cell
      values repr identically.

    If probing fails (e.g. the expr only accepts traced values) the
    signature falls back to identity, which can only cause cache misses,
    never wrong hits — cached programs keep their exprs alive, so a live
    entry's id cannot be reused by a different function.

    Symbolic :class:`Expr` trees short-circuit both captures: their
    structural signature is already an exact, process-stable content key
    (``Call`` nodes contribute their ``fn_name``), so rewritten programs
    fingerprint deterministically without any probing.
    """
    parts = []
    f = comp.expr
    if isinstance(f, Expr):
        return "e:" + hashlib.sha256(f.signature().encode()).hexdigest()[:16]
    code = getattr(f, "__code__", None)
    if code is not None:
        try:
            def cell_text(v: Any) -> str:
                # repr truncates large arrays ('...'), which would conflate
                # closures over arrays equal only at the printed corners
                if isinstance(v, np.ndarray):
                    digest = hashlib.sha256(np.ascontiguousarray(v).tobytes())
                    return f"nd{v.shape}{v.dtype}:{digest.hexdigest()[:16]}"
                return repr(v)

            cells = tuple(
                cell_text(c.cell_contents)
                for c in (getattr(f, "__closure__", None) or ())
            )
            src = (code.co_code.hex() + repr(code.co_consts) + repr(code.co_names)
                   + repr(cells) + repr(getattr(f, "__defaults__", None)))
            parts.append("c:" + hashlib.sha256(src.encode()).hexdigest()[:16])
        except Exception:
            pass
    n = len(comp.reads)
    probes = (
        [1.0] * n,
        [0.5 + 0.375 * k for k in range(n)],
        [-1.25 + 0.5 * k for k in range(n)],
        [3.75 - 0.625 * k for k in range(n)],
        [-4.5 + 1.125 * k for k in range(n)],
    )
    vals = []
    for p in probes:
        try:
            v = float(f(*[np.float64(x) for x in p]))
        except Exception:
            if parts:  # bytecode hash alone still identifies the function
                return parts[0]
            return f"opaque@{id(f):x}"
        vals.append(f"{v:.12g}" if np.isfinite(v) else repr(v))
    parts.append(",".join(vals))
    return "|".join(parts)


def program_fingerprint(program: Program, content: bool = True) -> str:
    """Stable whole-program fingerprint: arrays, temps, body, expr content.

    Invariant to iterator renaming (via the per-nest ``fingerprint``) and to
    the program's display name, so structurally-identical programs — the
    paper's A/B variants after normalization, or a re-built config — address
    the same cache slot.  With ``content=True`` (the default used by the
    compilation cache) each computation's scalar expression is probed so that
    structure-equal programs computing different math stay distinct.
    """
    arrays = ";".join(
        f"{a.name}:{'x'.join(map(str, a.shape))}:{a.dtype}" for a in program.arrays
    )
    temps = ",".join(sorted(program.temps))
    body = "|".join(fingerprint(n) for n in program.body)
    text = f"arrays({arrays})temps({temps})body({body})"
    if content:
        exprs = "|".join(_expr_signature(c) for _, c in program_computations(program))
        text += f"exprs({exprs})"
    return hashlib.sha256(text.encode()).hexdigest()
