"""Dependence analysis for the loop-nest IR.

Port of ``repro/core/dependence.py``: a copy that changes only its import roots.

Provides the two legality oracles the normalization passes need (paper §2):

* ``body_dependence_graph``  — edges between the children of a loop, used by
  maximal loop fission (classic loop-distribution legality: SCC condensation
  of the dependence graph, emitted in topological order).
* ``nest_direction_vectors`` — direction vectors over a nest's iterators, used
  by stride minimization (a permutation is legal iff every dependence's
  permuted direction vector stays lexicographically non-negative).

Directions are represented per iterator as one of ``'=' '<' '>' '*'`` where
``'<'`` means the dependence flows from an earlier to a later iteration
(positive distance).  Anything we cannot solve exactly becomes ``'*'``
(conservative: blocks the transformation).  Reduction self-dependences of
computations flagged ``accumulate`` are treated as reorderable (associative
rewrites are permitted, as in the paper's GEMM interchange).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Sequence

from .ir import (
    NONAFFINE,
    Access,
    Computation,
    Loop,
    Node,
    Program,
    walk,
)

EQ, LT, GT, ANY = "=", "<", ">", "*"


def _conflict(a: Access, b: Access, a_writes: bool, b_writes: bool) -> bool:
    return a.array == b.array and (a_writes or b_writes)


_COMMUTATIVE = ("+", "*", "max", "min")


def access_pairs(
    c1: Computation, c2: Computation
) -> Iterable[tuple[Access, Access]]:
    """All conflicting (at least one write) access pairs between c1 and c2.

    Write-write pairs where BOTH computations accumulate with the same
    commutative-associative operator are skipped: two ``+=`` updates to the
    same container commute regardless of interleaving, so they impose no
    ordering (this is what lets e.g. syr2k's two MACs fission apart)."""
    both_acc = (
        c1.accumulate is not None
        and c1.accumulate == c2.accumulate
        and c1.accumulate in _COMMUTATIVE
    )
    for a in c1.accesses():
        a_w = a is c1.write
        for b in c2.accesses():
            b_w = b is c2.write
            if a_w and b_w and both_acc:
                continue
            if _conflict(a, b, a_w, b_w):
                yield a, b


def _solve_directions(
    a: Access,
    b: Access,
    shared: Sequence[str],
    trip: dict[str, int],
) -> dict[str, str] | None:
    """Possible per-iterator directions for dependence instances a(I) ~ b(I').

    Returns None if no dependence can exist (e.g. constant offsets can never
    coincide), else a dict iterator -> direction describing delta = I - I'
    (``'<'`` ⇒ a's instance at a strictly earlier iteration than b's).

    Exact solving is restricted to the common case where both accesses use
    equal coefficients on the shared iterators per dimension; anything else
    (transposed accesses, non-affine terms, private iterators in a dimension)
    degrades to ``'*'`` for the involved iterators.
    """
    if len(a.index) != len(b.index):
        return {it: ANY for it in shared}

    # delta[it] = it_value_in_a - it_value_in_b, None = unconstrained so far
    delta: dict[str, int | None] = {it: None for it in shared}
    wild: set[str] = set()

    for ia, ib in zip(a.index, b.index):
        its = set(ia.iterators()) | set(ib.iterators())
        if ia.coeff(NONAFFINE) or ib.coeff(NONAFFINE):
            wild |= its & set(shared)
            continue
        priv = its - set(shared)
        sh = [it for it in shared if it in its]
        if priv:
            # a private iterator can absorb any difference
            wild |= set(sh)
            continue
        if not sh:
            if ia.const != ib.const:
                return None  # constant dims differ -> elements never overlap
            continue
        coeffs_equal = all(ia.coeff(it) == ib.coeff(it) for it in sh)
        if coeffs_equal and len(sh) == 1:
            it = sh[0]
            c = ia.coeff(it)
            rhs = ib.const - ia.const
            if c == 0:
                if rhs != 0:
                    return None
                continue
            if rhs % c != 0:
                return None
            d = rhs // c
            if abs(d) >= trip.get(it, 1 << 30):
                return None
            if delta[it] is None:
                delta[it] = d
            elif delta[it] != d:
                return None
        else:
            wild |= set(sh)

    out: dict[str, str] = {}
    for it in shared:
        if it in wild:
            out[it] = ANY
        elif delta[it] is None:
            out[it] = ANY  # unconstrained by any dimension
        elif delta[it] == 0:
            out[it] = EQ
        elif delta[it] < 0:
            # delta = I_a - I_b < 0: a's instance runs at an *earlier*
            # iteration than b's -> dependence flows a -> b.
            out[it] = LT
        else:
            out[it] = GT
    return out


def _is_reduction_self_dep(c1: Computation, c2: Computation, a: Access, b: Access) -> bool:
    """Self flow/output dep of an accumulating computation on its own target.

    Only the *same-index* self dependence (``C[i,j] (+)= f(..., C[i,j])``) is
    the associative-reduction dependence that permutation may reorder.  A read
    of the written array at a shifted index (``C[i,j] += C[i,j-1]``) is a real
    recurrence and must NOT be skipped.
    """
    return (
        c1 is c2
        and c1.accumulate is not None
        and a.array == c1.write.array
        and b.array == c1.write.array
        and a.index == b.index
    )


# ---------------------------------------------------------------------------
# Fission legality: dependence graph over a loop body's children
# ---------------------------------------------------------------------------
def _subtree_computations(n: Node) -> list[Computation]:
    if isinstance(n, Computation):
        return [n]
    return [c for _, c in walk(n)]


def body_dependence_graph(
    loop_iter: str, trip: dict[str, int], children: Sequence[Node]
) -> list[set[int]]:
    """adj[i] = set of j such that distributing child i after child j is unsafe
    unless i, j share a nest — i.e. there is a dependence edge i -> j.

    Edge semantics (execution order within one iteration of the loops outside
    ``loop_iter``): edge u -> v  ⇔  some instance of u must execute before some
    instance of v.  Children in the same SCC must remain fused; SCCs are
    emitted in topological order.
    """
    n = len(children)
    adj: list[set[int]] = [set() for _ in range(n)]
    comps = [_subtree_computations(ch) for ch in children]

    for i, j in itertools.combinations(range(n), 2):
        fwd = bwd = False  # i -> j, j -> i
        for c1 in comps[i]:
            for c2 in comps[j]:
                for a, b in access_pairs(c1, c2):
                    d = _solve_directions(a, b, [loop_iter], trip)
                    if d is None:
                        continue
                    s = d[loop_iter]
                    if s == EQ:
                        fwd = True  # same iteration: textual order i before j
                    elif s == LT:
                        fwd = True  # c1 instance earlier -> source i
                    elif s == GT:
                        bwd = True
                    else:  # ANY
                        fwd = bwd = True
                if fwd and bwd:
                    break
            if fwd and bwd:
                break
        if fwd:
            adj[i].add(j)
        if bwd:
            adj[j].add(i)
    return adj


def condense_sccs(adj: list[set[int]]) -> list[list[int]]:
    """Tarjan SCC condensation returning SCCs in topological order.

    Ties are broken so that the result is stable w.r.t. original child order.
    """
    n = len(adj)
    index = [-1] * n
    low = [0] * n
    on = [False] * n
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = [0]

    def strongconnect(v: int) -> None:
        """Iterative Tarjan visit from ``v`` (explicit stack, no recursion)."""
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if index[w] == -1:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on[w] = True
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif on[w]:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on[w] = False
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(sorted(scc))

    for v in range(n):
        if index[v] == -1:
            strongconnect(v)

    # Tarjan emits SCCs in reverse topological order.
    sccs.reverse()
    # Stable topological sort honoring textual order among independent SCCs.
    scc_of = {}
    for k, scc in enumerate(sccs):
        for v in scc:
            scc_of[v] = k
    edges = [set() for _ in sccs]
    indeg = [0] * len(sccs)
    for u in range(n):
        for v in adj[u]:
            a, b = scc_of[u], scc_of[v]
            if a != b and b not in edges[a]:
                edges[a].add(b)
                indeg[b] += 1
    import heapq

    ready = [(min(sccs[k]), k) for k in range(len(sccs)) if indeg[k] == 0]
    heapq.heapify(ready)
    order: list[list[int]] = []
    while ready:
        _, k = heapq.heappop(ready)
        order.append(sccs[k])
        for b in edges[k]:
            indeg[b] -= 1
            if indeg[b] == 0:
                heapq.heappush(ready, (min(sccs[b]), b))
    return order


# ---------------------------------------------------------------------------
# Permutation legality: direction vectors over a nest's iterators
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DepVector:
    """One dependence direction vector, aligned with the nest's iterators."""

    directions: tuple[str, ...]

    def permuted(self, perm: Sequence[int]) -> tuple[str, ...]:
        """The directions reordered under a loop permutation."""
        return tuple(self.directions[p] for p in perm)


def nest_direction_vectors(
    iterators: Sequence[str],
    trip: dict[str, int],
    computations: Sequence[Computation],
) -> list[DepVector]:
    """All dependence direction vectors among computations of one atomic nest."""
    vectors: set[tuple[str, ...]] = set()
    for c1 in computations:
        for c2 in computations:
            for a, b in access_pairs(c1, c2):
                if _is_reduction_self_dep(c1, c2, a, b):
                    # associative accumulation: reorderable by construction
                    continue
                d = _solve_directions(a, b, list(iterators), trip)
                if d is None:
                    continue
                vec = tuple(d[it] for it in iterators)
                if all(s == EQ for s in vec):
                    continue  # loop-independent: any permutation preserves it
                # Each dependence shows up in both (c1,c2) and (c2,c1) order;
                # keep only the positive orientation (first non-'=' is not '>')
                # — the mirrored, lexicographically-negative copy is redundant.
                lead = next(s for s in vec if s != EQ)
                if lead == GT:
                    continue
                vectors.add(vec)
    return [DepVector(v) for v in sorted(vectors)]


def permutation_legal(vectors: Iterable[DepVector], perm: Sequence[int]) -> bool:
    """Legal iff each permuted direction vector is lexicographically positive.

    Scan: '<' before any '>'/'*' makes the vector positive; '=' continues;
    '>' or '*' encountered first makes it (potentially) negative -> illegal.
    """
    for v in vectors:
        for s in v.permuted(perm):
            if s == LT:
                break
            if s == EQ:
                continue
            return False  # GT or ANY first
    return True
