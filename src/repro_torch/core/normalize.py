"""A priori loop nest normalization (paper §2): the two criteria.

Port of ``repro/core/normalize.py``: a copy that changes only its import roots.

Pass 1 — **maximal loop fission** (§2.1): split every loop body into the
finest legal pieces.  Children of a loop that have no mutual dependence are
divided into separate nests with cloned iterators; children in a dependence
cycle (an SCC) stay fused — the result is a sequence of *atomic* loop nests.
Applied as a fixed point over the tree (fissioning only ever shrinks bodies).

Pass 2 — **stride minimization** (§2.2): for every atomic nest, find the
legal loop permutation minimizing the stride criterion — the sum over all
computations and accesses of the address distance between two subsequent
(innermost-iteration) accesses, using row-major linearization.  ≤ MAX_ENUM
iterators are permuted exhaustively; deeper nests fall back to the paper's
group-sort approximation (order iterators by descending stride weight).

``normalize`` = fission → stride-minimization → canonical iterator renaming,
run as the canonical ``PassPipeline`` built by ``normalization_pipeline()``
(the scheduler extends the same pipeline with post-normalization
optimization passes such as re-fusion — see ``repro.core.fusion``).
"""
from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Mapping, Sequence

from .dependence import (
    DepVector,
    body_dependence_graph,
    condense_sccs,
    nest_direction_vectors,
    permutation_legal,
)
from .ir import (
    Access,
    Affine,
    Array,
    Computation,
    Loop,
    Node,
    Program,
    is_perfect_nest,
    loop_iterators,
    nest_computations,
    walk,
)
from .passes import FixpointPass, FunctionPass, PassPipeline

MAX_ENUM = 7  # exhaustive permutation bound (7! = 5040)


# ---------------------------------------------------------------------------
# Pass 0: scalar expansion (enables fission across scalar temporaries)
# ---------------------------------------------------------------------------
def scalar_expansion(program: Program) -> Program:
    """Expand 0-d scratch containers over their carrying loop (paper Fig. 10:
    ``ZQP`` -> ``ZQP_0(JL)``).

    A 0-d temp written and read inside a loop's body serializes the loop and
    welds otherwise-independent computations into one SCC.  If the first
    access in the subtree is an unguarded plain write (a dominating
    definition), each iteration owns its value and the temp can be promoted
    to an array indexed by the loop iterator.  Applied innermost-first, so
    temps are expanded only over the loop that actually carries them.
    """
    temps = set(program.temps)
    arrays = {a.name: a for a in program.arrays}

    def subtree_accesses(n: Node) -> list[tuple[Computation, Access, bool]]:
        """All (computation, access, is_write) triples under ``n``."""
        out = []
        if isinstance(n, Computation):
            for a in n.reads:
                out.append((n, a, False))
            out.append((n, n.write, True))
        else:
            for ch in n.body:
                out.extend(subtree_accesses(ch))
        return out

    def first_access_order(n: Node) -> list[tuple[Computation, Access, bool]]:
        """program order: within a computation, reads precede the write."""
        out = []
        if isinstance(n, Computation):
            for a in n.reads:
                out.append((n, a, False))
            out.append((n, n.write, True))
        else:
            for ch in n.body:
                out.extend(first_access_order(ch))
        return out

    def used_outside(name: str, inside: Node) -> bool:
        """Whether array ``name`` is accessed anywhere outside ``inside``."""
        cnt_inside = sum(1 for _, a, _ in subtree_accesses(inside) if a.array == name)
        total = 0
        for top in program.body:
            total += sum(1 for _, a, _ in subtree_accesses(top) if a.array == name)
        return total != cnt_inside

    def add_index(n: Node, name: str, it: str) -> Node:
        """Prepend iterator ``it`` to every access of array ``name``."""
        if isinstance(n, Computation):
            def fix(a: Access) -> Access:
                """Rewrite one access of the expanded array."""
                if a.array != name:
                    return a
                return Access(a.array, (Affine.of(it),) + a.index)

            return replace(
                n,
                write=fix(n.write),
                reads=tuple(fix(r) for r in n.reads),
            )
        return replace(n, body=tuple(add_index(b, name, it) for b in n.body))

    def rec(node: Node) -> Node:
        """Expand scalar temps carried by ``node``, innermost loops first."""
        if isinstance(node, Computation):
            return node
        node = replace(node, body=tuple(rec(b) for b in node.body))
        accesses = first_access_order(node)
        cands: dict[str, bool] = {}
        for comp, a, is_write in accesses:
            if a.array in temps and arrays[a.array].shape == ():
                if a.array not in cands:
                    # first access must be a dominating unguarded write
                    cands[a.array] = bool(
                        is_write and comp.accumulate is None and not comp.guards
                    )
                elif is_write and (comp.accumulate is not None or comp.guards):
                    cands[a.array] = False
        for name, ok in cands.items():
            writers = {id(c) for c, a, w in accesses if w and a.array == name}
            readers = {id(c) for c, a, w in accesses if not w and a.array == name}
            if not ok or not writers or not (readers - writers or len(writers) > 1):
                continue
            if used_outside(name, node):
                continue
            arrays[name] = Array(name, (node.stop,), arrays[name].dtype)
            node = replace(node, body=tuple(add_index(b, name, node.iterator) for b in node.body))
        return node

    new_body = tuple(rec(n) for n in program.body)
    return replace(program, body=new_body, arrays=tuple(arrays[a.name] for a in program.arrays))


# ---------------------------------------------------------------------------
# Pass 1: maximal loop fission
# ---------------------------------------------------------------------------
class _Fresh:
    def __init__(self) -> None:
        self.n = 0

    def __call__(self) -> str:
        self.n += 1
        return f"_f{self.n}"


def _trip_counts(node: Node, out: dict[str, int] | None = None) -> dict[str, int]:
    out = out if out is not None else {}
    if isinstance(node, Loop):
        out[node.iterator] = node.trip_count
        for b in node.body:
            _trip_counts(b, out)
    return out


def _fission_loop(loop: Loop, fresh: _Fresh) -> list[Node]:
    """Distribute one loop over the SCCs of its body's dependence graph."""
    # Recurse bottom-up first: fission inner loops.
    new_body: list[Node] = []
    for child in loop.body:
        if isinstance(child, Loop):
            new_body.extend(_fission_loop(child, fresh))
        else:
            new_body.append(child)
    loop = replace(loop, body=tuple(new_body))

    if len(loop.body) <= 1:
        return [loop]

    trip = _trip_counts(loop)
    adj = body_dependence_graph(loop.iterator, trip, loop.body)
    sccs = condense_sccs(adj)
    if len(sccs) == 1:
        return [loop]

    nests: list[Node] = []
    for scc in sccs:
        children = tuple(loop.body[k] for k in scc)
        piece = replace(loop, body=children)
        # clone iterators so each nest owns its own (paper: i'_1 = i_1, ...)
        its = loop_iterators(piece)
        mapping = {it: f"{it}{fresh()}" for it in its}
        nests.append(piece.rename(mapping))
    return nests


def maximal_fission(program: Program) -> Program:
    """Split every top-level loop into the finest legal (SCC-atomic) nests."""
    fresh = _Fresh()
    body: list[Node] = []
    for node in program.body:
        if isinstance(node, Loop):
            body.extend(_fission_loop(node, fresh))
        else:
            body.append(node)
    return replace(program, body=tuple(body))


# ---------------------------------------------------------------------------
# Pass 2: stride minimization
# ---------------------------------------------------------------------------
def access_stride(program: Program, a: Access, iterator: str) -> int:
    """|address delta| of access ``a`` between consecutive ``iterator`` steps."""
    arr = program.array(a.array)
    strides = arr.strides
    delta = 0
    for d, ix in enumerate(a.index):
        delta += strides[d] * ix.coeff(iterator)
    return abs(delta)


def stride_weights(
    program: Program, comps: Sequence[Computation], iterators: Sequence[str]
) -> dict[str, int]:
    """Per-iterator stride weight: the paper's sum over all (computation,
    access) pairs of the address delta between consecutive iterations.

    Computed ONCE per nest — a weight depends only on the iterator, never on
    its position in the loop order, so permutation enumeration can compare
    cost tuples by reordering these precomputed totals instead of re-walking
    every access for each of up to 7! candidate permutations.
    """
    return {
        it: sum(access_stride(program, a, it) for c in comps for a in c.accesses())
        for it in iterators
    }


def stride_cost(
    program: Program,
    comps: Sequence[Computation],
    order: Sequence[str],
    weights: Mapping[str, int] | None = None,
) -> tuple[int, ...]:
    """Cost tuple (innermost, ..., outermost): each entry is the paper's
    sum-of-strides criterion for that loop being the vectorized/fast axis.

    Comparing the tuples lexicographically implements "minimize the stride of
    subsequent accesses" with deterministic tie-breaking on outer levels.
    """
    if weights is None:
        weights = stride_weights(program, comps, order)
    return tuple(weights[it] for it in reversed(order))


def _legal_orders(
    iterators: Sequence[str],
    vectors: Sequence[DepVector],
) -> list[tuple[int, ...]]:
    perms = []
    for perm in itertools.permutations(range(len(iterators))):
        if permutation_legal(vectors, perm):
            perms.append(perm)
    return perms


def _greedy_order(
    iterators: Sequence[str],
    vectors: Sequence[DepVector],
    weights: Mapping[str, int],
) -> tuple[int, ...]:
    """Deep-nest approximation (paper §2.2): sort iterators by descending
    stride weight (largest stride outermost), keeping only legal placements.
    """
    desired = sorted(range(len(iterators)), key=lambda k: (-weights[iterators[k]], k))
    # insertion repair: greedily build a legal prefix
    chosen: list[int] = []
    remaining = list(desired)
    while remaining:
        for k in remaining:
            cand = chosen + [k] + [r for r in remaining if r != k]
            if permutation_legal(vectors, cand):
                chosen.append(k)
                remaining.remove(k)
                break
        else:  # nothing legal (shouldn't happen: identity is legal)
            chosen.extend(remaining)
            break
    return tuple(chosen)


def _permute_perfect_nest(program: Program, root: Loop) -> Loop:
    """Reorder the loop chain of a perfect nest to the minimal-stride order."""
    chain: list[Loop] = [root]
    node: Node = root
    while isinstance(node, Loop) and len(node.body) == 1 and isinstance(node.body[0], Loop):
        node = node.body[0]
        chain.append(node)
    innermost = chain[-1]
    comps = nest_computations(root)
    iterators = [l.iterator for l in chain]
    trip = {l.iterator: l.trip_count for l in chain}
    vectors = nest_direction_vectors(iterators, trip, comps)

    if len(chain) <= 1:
        return root
    # one access walk per nest; enumeration below only reorders these totals
    weights = stride_weights(program, comps, iterators)
    if len(chain) <= MAX_ENUM:
        orders = _legal_orders(iterators, vectors)
        if not orders:
            # '*' directions can make even the identity unprovable — the
            # original order is trivially legal, keep it (paper's fallback:
            # "the loop nest is not optimized").
            orders = [tuple(range(len(iterators)))]
        best = min(
            orders,
            key=lambda p: (
                stride_cost(program, comps, [iterators[k] for k in p], weights), p
            ),
        )
    else:
        best = _greedy_order(iterators, vectors, weights)

    # rebuild the chain in the chosen order
    body = innermost.body
    for k in reversed(best):
        l = chain[k]
        body = (replace(l, body=body),)
    return body[0]


def _minimize_node(program: Program, node: Node) -> Node:
    if isinstance(node, Computation):
        return node
    if is_perfect_nest(node):
        return _permute_perfect_nest(program, node)
    # imperfect nest (an atomic SCC with computations at several levels):
    # recurse into children; the shared outer loop is left in place.
    return replace(node, body=tuple(_minimize_node(program, b) for b in node.body))


def stride_minimization(program: Program) -> Program:
    """Permute each nest so smaller-stride iterators sit innermost."""
    return replace(
        program, body=tuple(_minimize_node(program, n) for n in program.body)
    )


# ---------------------------------------------------------------------------
# Canonical renaming + pipeline
# ---------------------------------------------------------------------------
def canonical_rename(program: Program) -> Program:
    """Rename iterators i0, i1, ... by traversal order (stable fingerprints)."""
    counter = [0]

    def ren(node: Node) -> Node:
        """Rename one nest's iterators from the running counter."""
        if isinstance(node, Computation):
            return node
        its = loop_iterators(node)
        mapping = {}
        for it in its:
            mapping[it] = f"i{counter[0]}"
            counter[0] += 1
        return node.rename(mapping)

    return replace(program, body=tuple(ren(n) for n in program.body))


def normalization_pipeline() -> PassPipeline:
    """The a priori normalization passes (paper Fig. 5) as an explicit,
    editable pipeline.  Fission runs to a fixed point (each application only
    ever splits further); canonical renaming is last so fingerprints are
    stable under whatever passes are inserted before it."""
    return PassPipeline(
        [
            FunctionPass("scalar_expansion", scalar_expansion),
            FixpointPass("maximal_fission", maximal_fission),
            FunctionPass("stride_minimization", stride_minimization),
            FunctionPass("canonical_rename", canonical_rename),
        ],
        name="normalize",
    )


# the canonical instance `normalize()` runs (tools may inspect/extend it via
# `normalization_pipeline()` without touching this shared one)
NORMALIZE_PIPELINE = normalization_pipeline()


def normalize(program: Program) -> Program:
    """The full a priori normalization pipeline (paper Fig. 5)."""
    return NORMALIZE_PIPELINE.run(program)
