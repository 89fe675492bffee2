"""Canonical-form re-fusion — the first post-normalization optimization pass.

Port of ``repro/core/fusion.py``: a copy; its code differs only in import roots.

Maximal fission (paper §2.1) splits every loop body into the finest legal
pieces so each atomic nest can be scheduled independently.  That is ideal
for *analysis* but pessimal for *execution* of elementwise chains: a
CLOUDSC-style guarded update sequence or a softmax/rmsnorm pipeline becomes
N kernels making N full passes over memory, each materializing its
intermediate.

``FusionPass`` runs after normalization and greedily re-fuses *adjacent*
sibling nests (at every nesting level) when

  1. their iteration domains match — both are perfect nests whose loop
     chains agree in (start, stop, step) level by level,
  2. neither side matches a library-call idiom (blas3/blas2/dot stay
     standalone so einsum/Pallas dispatch keeps seeing a single
     contraction) nor a recurrence (carried nests stay untouched), and
  3. no fusion-preventing dependence exists: for every conflicting access
     pair between the two bodies (second nest's iterators mapped onto the
     first's by position), the solved direction vector must not be
     lexicographically positive — an instance of the earlier nest may never
     end up running *after* the later-nest instance that depends on it.
     Unknown ('*') directions conservatively block fusion.

Legality reuses the normalizer's dependence machinery
(``access_pairs`` / ``_solve_directions``), so the oracle that proves
fission legal is the same one that proves re-fusion legal.
"""
from __future__ import annotations

from dataclasses import replace

from .dependence import ANY, EQ, GT, access_pairs, _solve_directions
from .idioms import classify_nest
from .ir import Computation, Loop, Node, Program
from .normalize import normalization_pipeline
from .passes import PassContext, PassPipeline

# Idioms that must stay standalone: the scheduler lowers them as single
# library calls (einsum / the GEMM kernel); fusing an elementwise tail
# into them would break the dispatch back to a generic loop.
LIBRARY_IDIOMS = frozenset({"blas3", "blas2", "dot"})
_NO_FUSE = LIBRARY_IDIOMS | {"recurrence"}


def _perfect_chain(node: Node) -> list[Loop] | None:
    """The loop chain of a perfect nest (computations only at the innermost
    level), or None for computations / imperfect nests."""
    if isinstance(node, Computation):
        return None
    chain: list[Loop] = []
    cur: Node = node
    while isinstance(cur, Loop):
        chain.append(cur)
        kids = cur.body
        if all(isinstance(k, Computation) for k in kids):
            return chain
        if len(kids) != 1:
            return None  # multiple loop children: imperfect
        cur = kids[0]
    return None


def _chains_match(c1: list[Loop] | None, c2: list[Loop] | None) -> bool:
    if c1 is None or c2 is None or len(c1) != len(c2) or not c1:
        return False
    return all(
        (a.start, a.stop, a.step) == (b.start, b.stop, b.step)
        for a, b in zip(c1, c2)
    )


def domains_match(n1: Node, n2: Node) -> bool:
    """Both perfect nests with level-by-level equal (start, stop, step)."""
    return _chains_match(_perfect_chain(n1), _perfect_chain(n2))


def fusion_legal(n1: Node, n2: Node) -> bool:
    """No fusion-preventing dependence between adjacent nests n1, n2.

    Originally every instance of n1 executes before every instance of n2.
    After fusion both bodies run under n1's loops, n1's computations first
    within each iteration, iterations in lexicographic order.  A conflicting
    access pair a(I1) ~ b(I2) (a from n1, b from n2, iterators aligned by
    position) keeps its original order iff I1 <= I2; a dependence instance
    with I1 > I2 — direction vector lexicographically positive, leading
    ``'>'`` — would be reversed, so it prevents fusion.  ``'*'`` (unsolvable)
    may hide such an instance and blocks conservatively.  Enclosing shared
    loops need no check: fusing siblings never reorders across their
    iterations.
    """
    c1, c2 = _perfect_chain(n1), _perfect_chain(n2)
    return _chains_match(c1, c2) and _legal_chains(c1, c2)


def _legal_chains(c1: list[Loop], c2: list[Loop]) -> bool:
    mapping = {b.iterator: a.iterator for a, b in zip(c1, c2)}
    iterators = [l.iterator for l in c1]
    trip = {l.iterator: l.trip_count for l in c1}
    comps1 = list(c1[-1].body)
    comps2 = [c.rename(mapping) for c in c2[-1].body]

    for u in comps1:
        for v in comps2:
            # Two same-operator accumulations into one container commute —
            # ``access_pairs`` drops the pair, so the dependence test cannot
            # see it — but fusing them interleaves the accumulation order.
            # That is numerically legal yet reassociates floating point; we
            # promise fused programs stay bit-identical to the oracle, so
            # keep such nests (e.g. syr2k's two triangular MACs) apart.
            if (
                u.accumulate is not None
                and u.accumulate == v.accumulate
                and u.write.array == v.write.array
            ):
                return False
            for a, b in access_pairs(u, v):
                d = _solve_directions(a, b, iterators, trip)
                if d is None:
                    continue  # accesses can never coincide
                for it in iterators:
                    s = d[it]
                    if s == EQ:
                        continue
                    if s == GT or s == ANY:
                        return False  # (potentially) lex-positive: reversed
                    break  # '<' leads: strictly earlier, order preserved
    return True


def _fuse_chains(c1: list[Loop], c2: list[Loop]) -> Loop:
    mapping = {b.iterator: a.iterator for a, b in zip(c1, c2)}
    merged = tuple(c1[-1].body) + tuple(c.rename(mapping) for c in c2[-1].body)
    body: tuple[Node, ...] = merged
    for loop in reversed(c1):
        body = (replace(loop, body=body),)
    return body[0]


def fuse_pair(n1: Node, n2: Node) -> Node:
    """Merge n2's computations into n1's loop chain (callers prove legality)."""
    c1, c2 = _perfect_chain(n1), _perfect_chain(n2)
    assert c1 is not None and c2 is not None and len(c1) == len(c2)
    return _fuse_chains(c1, c2)


def fuse_siblings(
    siblings: tuple[Node, ...], stats: dict[str, int]
) -> tuple[Node, ...]:
    """Greedy adjacent re-fusion over one body, innermost-first."""
    # recurse first so already-fused inner groups are visible to idiom checks
    recursed: list[Node] = []
    for n in siblings:
        if isinstance(n, Loop):
            n = replace(n, body=fuse_siblings(n.body, stats))
        recursed.append(n)

    # idiom memo (classification probes exprs).  Values keep the classified
    # node alive, so a recycled id() can never alias a freed node's entry.
    kinds: dict[int, tuple[Node, str]] = {}

    def kind(n: Node) -> str:
        """Memoized idiom kind of a candidate nest."""
        hit = kinds.get(id(n))
        if hit is None or hit[0] is not n:
            hit = (n, classify_nest(n).kind)
            kinds[id(n)] = hit
        return hit[1]

    out: list[Node] = []
    for nxt in recursed:
        while out:
            cur = out[-1]
            if not (isinstance(cur, Loop) and isinstance(nxt, Loop)):
                break
            c_cur, c_nxt = _perfect_chain(cur), _perfect_chain(nxt)
            if not _chains_match(c_cur, c_nxt):
                stats["domain_mismatch"] += 1
                break
            if kind(cur) in _NO_FUSE or kind(nxt) in _NO_FUSE:
                stats["idiom_guarded"] += 1
                break
            if not _legal_chains(c_cur, c_nxt):
                stats["dependence_blocked"] += 1
                break
            out.pop()
            nxt = _fuse_chains(c_cur, c_nxt)
            stats["fused"] += 1
        out.append(nxt)
    return tuple(out)


def _new_stats() -> dict[str, int]:
    return {"fused": 0, "idiom_guarded": 0,
            "domain_mismatch": 0, "dependence_blocked": 0}


def fuse_program(program: Program) -> Program:
    """Functional entry point: re-fuse all fusable adjacent nests."""
    return replace(program, body=fuse_siblings(program.body, _new_stats()))


class FusionPass:
    """Pass-protocol wrapper recording fusion stats into the PassContext."""

    name = "fusion"

    def run(self, program: Program, ctx: PassContext | None = None) -> Program:
        """Fuse adjacent nests, attaching merge/guard counters to ``ctx``."""
        stats = _new_stats()
        out = replace(program, body=fuse_siblings(program.body, stats))
        if ctx is not None:
            for k, v in stats.items():
                ctx.add_stat(self.name, k, v)
        return out


def optimization_pipeline(fuse: bool = True, rewrite: bool = True) -> PassPipeline:
    """The full normalize-then-optimize pipeline the scheduler runs:
    COFFEE-style expression rewrites (LICM, expansion/factorization, CSE)
    run on the maximally-fissioned form, then re-fusion slots in between
    them and canonical renaming, so fingerprints stay stable however the
    rewrites and fusion reshaped the nest structure.  ``fuse=False``
    with ``rewrite=False`` degrades to exactly the paper's a priori
    normalization.
    """
    from .rewrite import rewrite_passes  # local import: rewrite -> passes -> ir

    pipeline = normalization_pipeline()
    licm, expand_factor, cse = rewrite_passes()
    if rewrite:
        pipeline = pipeline.with_pass(licm, before="canonical_rename")
        pipeline = pipeline.with_pass(expand_factor, before="canonical_rename")
        pipeline.name = "optimize"
    if fuse:
        pipeline = pipeline.with_pass(FusionPass(), before="canonical_rename")
        pipeline.name = "optimize"
    if rewrite:
        # CSE hunts duplicates *across* the computations sharing one nest
        # body, which only exist after re-fusion merges sibling nests — on
        # the maximally-fissioned form every nest holds a single computation.
        pipeline = pipeline.with_pass(cse, before="canonical_rename")
    return pipeline
