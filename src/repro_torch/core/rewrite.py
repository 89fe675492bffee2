"""COFFEE-style expression rewrites on the canonical form.

Port of ``repro/core/rewrite.py``: a copy that changes only its import roots.

The normalization pipeline (paper §2) reshapes *loops*; these passes reshape
the *scalar math inside* them, in the spirit of COFFEE's rewrite engine:
flop-reducing, oracle-checked transformations that run after maximal fission
and before re-fusion, so the scheduler's recipes see the cheapest equivalent
computation.  All passes are identity on computations whose ``expr`` is an
opaque callable — only symbolic :class:`repro.core.ir.Expr` trees are
inspected — and identity whenever a cost guard or legality check fails, so
slotting them into the pipeline can never regress an unmigrated front-end.

* ``LICMPass`` — loop-invariant code motion.  A subexpression whose reads
  use only a proper subset of the enclosing loop iterators is hoisted into a
  scratch array filled by a new sibling nest placed just before the current
  one; the computation then reads the scratch value instead of recomputing
  the subexpression on every iteration of the invariant loops.  Equal
  subexpressions over never-written inputs share one scratch array across
  *all* top-level nests.  Note XLA's while-loop invariant code motion
  already subsumes the easy case (a chain over closure-captured constants
  inside one ``lax.scan`` body is hoisted to the entry computation), so that
  shape shows no end-to-end win.  What XLA cannot do — and LICM can, because
  the IR knows the iteration space — is hoist work that reads the per-step
  slices of a scanned field (syntactically step-dependent in HLO, invariant
  along the *inner* band/species axis in the IR), or share one evaluation
  across several separate scans.  That is exactly the
  ``saturation_chain_program`` shape ``bench_rewrite`` gates on, and the
  transformation is bit-exact (the same float ops run, just once).
* ``ExpandFactorPass`` — expansion ``(a+b)*c -> ac+bc`` and factorization
  ``ab+ac -> a(b+c)`` as a cost-guarded fixpoint pair.  Expansion splits a
  sum-of-products accumulation into one accumulation per product term (each
  its own sibling nest), which is what unlocks BLAS idiom dispatch — a
  ``(A+B)@C``-style MAC is not multiplicative as written, but each expanded
  term is.  Factorization merges terms sharing a non-constant factor when
  that strictly reduces the op count.  Both reassociate floating point, so
  they are gated by ``allclose`` (not bit-identity) in the benchmark.
* ``CSEPass`` — common subexpression elimination across the computations of
  one nest: a duplicated subtree whose support covers the full iterator set
  is materialized once into a scratch array written by a new leading
  computation, and every user reads it back.  Within a single expression,
  duplicates already cost nothing (``Expr.to_callable`` deduplicates the
  DAG), so only cross-computation duplicates are considered.

Legality is deliberately conservative: a subexpression is only hoisted or
shared when none of the arrays it reads are written anywhere in the nest,
which makes the scratch value trivially iteration-invariant (hoisting) or
order-independent (CSE).  Guards never block a rewrite — scratch values are
computed over the full rectangular domain (overcompute is harmless; the
guarded points simply never read them).
"""
from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Iterable

from .ir import (
    Access,
    Array,
    BinOp,
    Call,
    Computation,
    Const,
    Expr,
    Loop,
    Neg,
    Node,
    Program,
    Read,
    aff,
    expr_map_reads,
    expr_nodes,
    expr_ops,
    expr_reads,
    rename_nest,
    walk,
)
from .passes import PassContext

MIN_HOIST_OPS = 2  # don't trade a memory round-trip for a single flop
MAX_EXPAND_TERMS = 4


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def is_symbolic(comp: Computation) -> bool:
    """True when the computation's expr is an inspectable ``Expr`` tree."""
    return isinstance(comp.expr, Expr)


def _written_arrays(node: Node) -> set[str]:
    if isinstance(node, Computation):
        return {node.write.array}
    return {c.write.array for _, c in walk(node)}


def resolved_signature(
    e: Expr,
    reads: tuple[Access, ...],
    rename: dict[str, str] | None = None,
) -> str:
    """Structural signature with ``Read(i)`` resolved to its access.

    Two subtrees in different computations of the same nest get equal keys
    iff they compute the same value at every iteration point (same ops over
    the same array elements).  Iterator names are compared literally unless
    ``rename`` maps them to a canonical spelling — LICM passes a positional
    one so fission-suffixed siblings (``JL_f1`` vs ``JL_f2``) still share a
    hoisted temp.
    """
    if isinstance(e, Read):
        a = reads[e.i]
        if rename:
            a = a.rename(rename)
        return f"{a.array}[{','.join(repr(ix) for ix in a.index)}]"
    if isinstance(e, Const):
        return repr(e.value)
    kids = " ".join(resolved_signature(c, reads, rename) for c in e.children())
    if isinstance(e, BinOp):
        return f"({e.op} {kids})"
    if isinstance(e, Neg):
        return f"(neg {kids})"
    return f"(call {e.fn_name} {kids})"  # Call


def _expr_read_accesses(e: Expr, comp: Computation) -> list[Access]:
    """The accesses referenced by ``e``, in first-use order, deduplicated."""
    out: list[Access] = []
    for i in expr_reads(e):
        a = comp.reads[i]
        if a not in out:
            out.append(a)
    return out


def _subexpr_support(e: Expr, comp: Computation) -> set[str]:
    """Iterators the subexpression's value actually varies over."""
    sup: set[str] = set()
    for i in expr_reads(e):
        sup.update(comp.reads[i].iterators())
    return sup


def _contains_call(e: Expr) -> bool:
    return any(isinstance(n, Call) for n in expr_nodes(e))


def program_flops(p: Program) -> int:
    """Weighted flop count of all symbolic computations, trip-weighted.

    Opaque exprs contribute nothing (they cannot be inspected); guards are
    ignored (a rectangular overestimate).  The rewrite passes report this
    before/after so ``PassContext.report()`` shows the work they removed.
    """
    total = 0
    for nest in p.body:
        for loops, comp in walk(nest):
            if not is_symbolic(comp):
                continue
            trip = 1
            for l in loops:
                trip *= max(1, l.trip_count)
            total += expr_ops(comp.expr) * trip
    return total


def _map_comps(node: Node, fn, prefix: tuple[Loop, ...] = ()) -> Node:
    """Rebuild a nest, mapping every computation through ``fn(loops, comp)``."""
    if isinstance(node, Computation):
        return fn(prefix, node)
    return replace(
        node,
        body=tuple(_map_comps(b, fn, prefix + (node,)) for b in node.body),
    )


def _fresh_name(base: str, taken: set[str]) -> str:
    if base not in taken:
        return base
    for k in itertools.count(1):  # pragma: no cover - collision fallback
        if f"{base}_{k}" not in taken:
            return f"{base}_{k}"
    raise AssertionError  # pragma: no cover


# ---------------------------------------------------------------------------
# loop-invariant code motion
# ---------------------------------------------------------------------------
class LICMPass:
    """Hoist invariant subexpressions into temps filled by sibling nests."""

    name = "licm"

    def run(self, program: Program, ctx: PassContext | None = None) -> Program:
        """Apply LICM to every top-level nest; record hoist/flop stats."""
        flops_before = program_flops(program)
        taken = set(program.array_names)
        counter = itertools.count()
        suffix = itertools.count()
        arrays = list(program.arrays)
        temps = list(program.temps)
        body: list[Node] = []
        hoisted = 0
        reused = 0

        # Arrays written by *any* nest: a hoisted temp may only be shared
        # across top-level nests when its sources are program inputs (never
        # written), otherwise a later nest could observe stale values.
        global_written: set[str] = set()
        for nest in program.body:
            global_written |= _written_arrays(nest)
        shared_cache: dict[str, tuple[str, tuple[int, ...]]] = {}

        for nest in program.body:
            if not isinstance(nest, Loop):
                body.append(nest)
                continue
            written = _written_arrays(nest)
            cache: dict[str, tuple[str, tuple[int, ...]]] = {}
            pre: list[Node] = []

            def visit(loops: tuple[Loop, ...], comp: Computation) -> Computation:
                """Hoist qualifying subexpressions out of one computation."""
                nonlocal hoisted
                if not is_symbolic(comp) or not loops:
                    return comp
                its = [l.iterator for l in loops]
                trips = {l.iterator: max(1, l.trip_count) for l in loops}
                # positional spelling, so fission-suffixed sibling chains
                # (JL_f1 vs JL_f2, same bounds) share one hoisted temp
                canon = {
                    l.iterator: f"@{pos}:{l.start}:{l.stop}:{l.step}"
                    for pos, l in enumerate(loops)
                }
                new_reads = list(comp.reads)

                def qualifies(e: Expr) -> tuple[int, ...] | None:
                    """Loop positions a hoistable subexpression varies over,
                    or None when hoisting is illegal or not profitable."""
                    accs = [comp.reads[i] for i in expr_reads(e)]
                    if any(not a.is_affine for a in accs):
                        return None
                    if any(a.array in written for a in accs):
                        return None
                    sup = _subexpr_support(e, comp)
                    if not sup.issubset(its) or sup == set(its):
                        return None
                    dropped = 1
                    for it in its:
                        if it not in sup:
                            dropped *= trips[it]
                    if dropped < 2:
                        return None
                    if expr_ops(e) < MIN_HOIST_OPS and not _contains_call(e):
                        return None
                    return tuple(p for p, it in enumerate(its) if it in sup)

                def hoist(e: Expr, sup: tuple[int, ...]) -> Expr:
                    """Materialize ``e`` into a (possibly shared) temp and
                    return the ``Read`` that replaces it."""
                    nonlocal hoisted, reused
                    key = resolved_signature(e, comp.reads, canon)
                    shareable = all(
                        comp.reads[i].array not in global_written
                        for i in expr_reads(e))
                    hit = cache.get(key)
                    if hit is None and shareable:
                        hit = shared_cache.get(key)
                        if hit is not None:
                            reused += 1
                            cache[key] = hit
                    if hit is None:
                        tname = _fresh_name(f"_licm{next(counter)}", taken)
                        taken.add(tname)
                        sup_loops = [loops[p] for p in sup]
                        shape = tuple(l.stop for l in sup_loops)
                        accs = _expr_read_accesses(e, comp)
                        remap = {
                            i: accs.index(comp.reads[i]) for i in expr_reads(e)
                        }
                        hcomp = Computation(
                            f"licm_{comp.name}",
                            Access(tname,
                                   tuple(aff(l.iterator) for l in sup_loops)),
                            tuple(accs),
                            expr_map_reads(e, remap),
                        )
                        hnest: Node = hcomp
                        for l in reversed(sup_loops):
                            hnest = Loop(l.iterator, l.stop, l.start, l.step,
                                         (hnest,))
                        if sup_loops:
                            hnest = rename_nest(hnest, f"_h{next(suffix)}")
                        pre.append(hnest)
                        arrays.append(Array(tname, shape))
                        temps.append(tname)
                        cache[key] = (tname, sup)
                        if shareable:
                            shared_cache[key] = cache[key]
                        hit = cache[key]
                        hoisted += 1
                    tname, sup = hit
                    acc_t = Access(tname, tuple(aff(its[p]) for p in sup))
                    if acc_t in new_reads:
                        idx = new_reads.index(acc_t)
                    else:
                        idx = len(new_reads)
                        new_reads.append(acc_t)
                    return Read(idx)

                def rw(e: Expr) -> Expr:
                    """Rewrite the tree top-down, hoisting maximal subtrees."""
                    if isinstance(e, (Read, Const)):
                        return e
                    sup = qualifies(e)
                    if sup is not None:
                        return hoist(e, sup)
                    kids = e.children()
                    return e.rebuild(tuple(rw(c) for c in kids)) if kids else e

                new_expr = rw(comp.expr)
                if new_expr is comp.expr and len(new_reads) == len(comp.reads):
                    return comp
                return replace(comp, reads=tuple(new_reads), expr=new_expr)

            new_nest = _map_comps(nest, visit)
            body.extend(pre)
            body.append(new_nest)

        if ctx is not None:
            ctx.add_stat(self.name, "hoisted", hoisted)
            if reused:
                ctx.add_stat(self.name, "reused", reused)
            if hoisted:
                out = replace(program, arrays=tuple(arrays),
                              body=tuple(body), temps=tuple(temps))
                ctx.add_stat(self.name, "flops_before", flops_before)
                ctx.add_stat(self.name, "flops_after", program_flops(out))
                return out
        if not hoisted:
            return program
        return replace(program, arrays=tuple(arrays), body=tuple(body),
                       temps=tuple(temps))


# ---------------------------------------------------------------------------
# expansion + factorization (cost-guarded fixpoint pair)
# ---------------------------------------------------------------------------
def _flat_add(e: Expr) -> list[Expr]:
    if isinstance(e, BinOp) and e.op == "add":
        return _flat_add(e.lhs) + _flat_add(e.rhs)
    return [e]


def _flat_mul(e: Expr) -> list[Expr]:
    if isinstance(e, BinOp) and e.op == "mul":
        return _flat_mul(e.lhs) + _flat_mul(e.rhs)
    return [e]


def _build_chain(op: str, terms: list[Expr]) -> Expr:
    out = terms[0]
    for t in terms[1:]:
        out = BinOp(op, out, t)
    return out


def _is_product(e: Expr) -> bool:
    """A pure product term: Mul/Neg over reads and constants only."""
    for n in expr_nodes(e):
        if isinstance(n, (Read, Const, Neg)):
            continue
        if isinstance(n, BinOp) and n.op == "mul":
            continue
        return False
    return True


def _distribute(e: Expr) -> list[Expr]:
    """Top-level add terms after distributing products over sums."""
    if isinstance(e, BinOp) and e.op == "add":
        return _distribute(e.lhs) + _distribute(e.rhs)
    if isinstance(e, BinOp) and e.op == "mul":
        lt, rt = _distribute(e.lhs), _distribute(e.rhs)
        if len(lt) * len(rt) == 1:
            return [e]
        return [BinOp("mul", a, b) for a in lt for b in rt]
    return [e]


def _factor_once(e: Expr) -> Expr:
    """One bottom-up factorization sweep: ``ab+ac -> a(b+c)`` when cheaper."""
    kids = e.children()
    if kids:
        e = e.rebuild(tuple(_factor_once(c) for c in kids))
    if not (isinstance(e, BinOp) and e.op == "add"):
        return e
    terms = _flat_add(e)
    factors = [ [f for f in _flat_mul(t)] for t in terms]
    # first non-constant factor (by appearance) present in >= 2 terms
    shared: Expr | None = None
    for fs in factors:
        for f in fs:
            if isinstance(f, Const):
                continue
            hits = sum(
                1 for other in factors
                if any(g.signature() == f.signature() for g in other)
            )
            if hits >= 2:
                shared = f
                break
        if shared is not None:
            break
    if shared is None:
        return e
    sig = shared.signature()
    residuals, others, first_pos = [], [], None
    for pos, (t, fs) in enumerate(zip(terms, factors)):
        idx = next((k for k, g in enumerate(fs) if g.signature() == sig), None)
        if idx is None:
            others.append((pos, t))
            continue
        rest = fs[:idx] + fs[idx + 1:]
        residuals.append(_build_chain("mul", rest) if rest else Const(1.0))
        if first_pos is None:
            first_pos = pos
    merged = BinOp("mul", shared, _build_chain("add", residuals))
    new_terms = [t for _, t in others]
    new_terms.insert(
        sum(1 for pos, _ in others if pos < (first_pos or 0)), merged)
    new = _build_chain("add", new_terms)
    return new if expr_ops(new) < expr_ops(e) else e


def _perfect_single(nest: Node) -> tuple[list[Loop], Computation] | None:
    """(loop chain, the single computation) for a perfect 1-comp nest."""
    if not isinstance(nest, Loop):
        return None
    chain: list[Loop] = []
    cur: Node = nest
    while isinstance(cur, Loop):
        chain.append(cur)
        if len(cur.body) != 1:
            return None
        cur = cur.body[0]
    return chain, cur


class ExpandFactorPass:
    """Expansion and factorization to a cost-guarded fixpoint."""

    name = "expand_factor"
    max_iter = 8

    def run(self, program: Program, ctx: PassContext | None = None) -> Program:
        """Iterate expansion (nest splits) + factorization until stable."""
        flops_before = program_flops(program)
        expanded = factored = 0
        cur = program
        for _ in range(self.max_iter):
            nxt, ne = self._expand(cur)
            nxt, nf = self._factor(nxt)
            expanded += ne
            factored += nf
            if nxt.body == cur.body:
                break
            cur = nxt
        if ctx is not None:
            ctx.add_stat(self.name, "expanded", expanded)
            ctx.add_stat(self.name, "factored", factored)
            if expanded or factored:
                ctx.add_stat(self.name, "flops_before", flops_before)
                ctx.add_stat(self.name, "flops_after", program_flops(cur))
        return cur

    def _expand(self, program: Program) -> tuple[Program, int]:
        body: list[Node] = []
        count = 0
        for nest in program.body:
            ps = _perfect_single(nest)
            if ps is None:
                body.append(nest)
                continue
            chain, comp = ps
            w_its = {it for ix in comp.write.index for it in ix.iterators()}
            reduction = any(l.iterator not in w_its for l in chain)
            if (not is_symbolic(comp) or comp.accumulate != "+"
                    or not reduction):
                body.append(nest)
                continue
            terms = _distribute(comp.expr)
            if (len(terms) < 2 or len(terms) > MAX_EXPAND_TERMS
                    or not all(_is_product(t) for t in terms)):
                body.append(nest)
                continue
            for k, t in enumerate(terms):
                used = expr_reads(t)
                remap = {i: k2 for k2, i in enumerate(used)}
                piece = replace(
                    comp,
                    name=f"{comp.name}_e{k}",
                    reads=tuple(comp.reads[i] for i in used),
                    expr=expr_map_reads(t, remap),
                )
                pnest: Node = piece
                for l in reversed(chain):
                    pnest = Loop(l.iterator, l.stop, l.start, l.step, (pnest,))
                if k:
                    pnest = rename_nest(pnest, f"_e{k}")
                body.append(pnest)
            count += len(terms) - 1
        if not count:
            return program, 0
        return replace(program, body=tuple(body)), count

    def _factor(self, program: Program) -> tuple[Program, int]:
        count = 0

        def visit(loops: tuple[Loop, ...], comp: Computation) -> Computation:
            nonlocal count
            if not is_symbolic(comp):
                return comp
            new = _factor_once(comp.expr)
            if new.signature() == comp.expr.signature():
                return comp
            count += 1
            return replace(comp, expr=new)

        body = tuple(_map_comps(n, visit) for n in program.body)
        if not count:
            return program, 0
        return replace(program, body=body), count


# ---------------------------------------------------------------------------
# cross-computation CSE
# ---------------------------------------------------------------------------
def _perfect_multi(nest: Node) -> tuple[list[Loop], list[Computation]] | None:
    """(loop chain, innermost computations) for a perfect nest with >= 2."""
    if not isinstance(nest, Loop):
        return None
    chain: list[Loop] = []
    cur: Node = nest
    while isinstance(cur, Loop):
        chain.append(cur)
        if all(isinstance(k, Computation) for k in cur.body):
            comps = list(cur.body)
            return (chain, comps) if len(comps) >= 2 else None
        if len(cur.body) != 1:
            return None
        cur = cur.body[0]
    return None


class CSEPass:
    """Materialize subtrees duplicated across a nest's computations."""

    name = "cse"

    def run(self, program: Program, ctx: PassContext | None = None) -> Program:
        """Share full-support duplicated subexpressions through scratch."""
        flops_before = program_flops(program)
        taken = set(program.array_names)
        counter = itertools.count()
        arrays = list(program.arrays)
        temps = list(program.temps)
        body: list[Node] = []
        eliminated = 0

        for nest in program.body:
            pm = _perfect_multi(nest)
            if pm is None:
                body.append(nest)
                continue
            chain, comps = pm
            its = tuple(l.iterator for l in chain)
            written = _written_arrays(nest)
            for _ in range(16):
                target = self._best_duplicate(comps, its, written)
                if target is None:
                    break
                eliminated += 1
                comps = self._materialize(
                    target, comps, its, chain, arrays, temps, taken, counter)
            new: Node = replace(chain[-1], body=tuple(comps))
            for l in reversed(chain[:-1]):
                new = replace(l, body=(new,))
            body.append(new)

        if not eliminated:
            return program
        out = replace(program, arrays=tuple(arrays), body=tuple(body),
                      temps=tuple(temps))
        if ctx is not None:
            ctx.add_stat(self.name, "flops_before", flops_before)
            ctx.add_stat(self.name, "flops_after", program_flops(out))
        if ctx is not None:
            ctx.add_stat(self.name, "eliminated", eliminated)
        return out

    def _candidates(self, comp: Computation, its: tuple[str, ...],
                    written: set[str]) -> Iterable[tuple[str, Expr]]:
        if not is_symbolic(comp):
            return
        for e in expr_nodes(comp.expr):
            if isinstance(e, (Read, Const)):
                continue
            if expr_ops(e) < MIN_HOIST_OPS and not _contains_call(e):
                continue
            accs = [comp.reads[i] for i in expr_reads(e)]
            if any(a.array in written or not a.is_affine for a in accs):
                continue
            if _subexpr_support(e, comp) != set(its):
                continue
            yield resolved_signature(e, comp.reads), e

    def _best_duplicate(self, comps, its, written):
        seen: dict[str, list[tuple[int, Expr]]] = {}
        order: list[str] = []
        for ci, comp in enumerate(comps):
            per_comp: set[str] = set()
            for key, e in self._candidates(comp, its, written):
                if key in per_comp:
                    continue
                per_comp.add(key)
                if key not in seen:
                    order.append(key)
                seen.setdefault(key, []).append((ci, e))
        dups = [k for k in order if len(seen[k]) >= 2]
        if not dups:
            return None
        best = max(dups, key=lambda k: (expr_ops(seen[k][0][1]),
                                        -order.index(k)))
        return best, seen[best]

    def _materialize(self, target, comps, its, chain, arrays, temps, taken,
                     counter):
        key, users = target
        first = users[0][1]
        src = comps[users[0][0]]
        tname = _fresh_name(f"_cse{next(counter)}", taken)
        taken.add(tname)
        accs = _expr_read_accesses(first, src)
        remap = {i: accs.index(src.reads[i]) for i in expr_reads(first)}
        tcomp = Computation(
            f"cse_{src.name}",
            Access(tname, tuple(aff(it) for it in its)),
            tuple(accs),
            expr_map_reads(first, remap),
        )
        arrays.append(Array(tname, tuple(l.stop for l in chain)))
        temps.append(tname)
        user_ids = {ci for ci, _ in users}
        out = [tcomp]
        for ci, comp in enumerate(comps):
            if ci not in user_ids:
                out.append(comp)
                continue
            new_reads = list(comp.reads)
            acc_t = Access(tname, tuple(aff(it) for it in its))
            if acc_t in new_reads:
                idx = new_reads.index(acc_t)
            else:
                idx = len(new_reads)
                new_reads.append(acc_t)

            def rw(e: Expr) -> Expr:
                if resolved_signature(e, comp.reads) == key:
                    return Read(idx)
                kids = e.children()
                return e.rebuild(tuple(rw(c) for c in kids)) if kids else e

            out.append(replace(comp, reads=tuple(new_reads),
                               expr=rw(comp.expr)))
        return out


def rewrite_passes() -> tuple[LICMPass, ExpandFactorPass, CSEPass]:
    """The three rewrite passes in pipeline order (LICM first: hoisting a
    partial-support duplicate beats materializing it at full rank)."""
    return (LICMPass(), ExpandFactorPass(), CSEPass())
