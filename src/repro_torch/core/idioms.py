"""Idiom detection on canonical nests (paper §4: "idiom detection, i.e.,
replacing the loop nest with the matching BLAS library call").

Port of ``repro/core/idioms.py``: a copy whose code differs only in import
roots.

In the port the "library call" is the CUDA GEMM kernel (or
``torch.einsum``).  Detection requires the canonical form: after fission each
nest holds one computation class, and after stride minimization operand
layouts are predictable — this is why detection fails without normalization
(reproduced in benchmarks/fig9: idiom hit-rate with vs without).
"""
from __future__ import annotations

from dataclasses import dataclass

from .codegen import _is_multiplicative, _single_iter_dims
from .dependence import EQ, nest_direction_vectors
from .ir import Computation, Loop, Node, loop_iterators, nest_computations


@dataclass(frozen=True)
class IdiomMatch:
    """Result of idiom classification for one nest."""

    kind: str  # 'blas3' | 'blas2' | 'dot' | 'stencil' | 'elementwise' | 'reduction' | 'recurrence'
    detail: str = ""


def _trips(nest: Node) -> dict[str, int]:
    out: dict[str, int] = {}

    def rec(n: Node) -> None:
        if isinstance(n, Loop):
            out[n.iterator] = n.trip_count
            for b in n.body:
                rec(b)

    rec(nest)
    return out


def classify_nest(nest: Node) -> IdiomMatch:
    """Classify a canonical nest into the recipe-selection idiom taxonomy.

    Carried dependences win (recurrence); otherwise single-computation
    multiplicative reductions map to blas3/blas2/dot by output rank, and the
    rest split into reduction, stencil and elementwise.
    """
    comps = nest_computations(nest)
    iterators = list(loop_iterators(nest)) if isinstance(nest, Loop) else []
    vectors = nest_direction_vectors(iterators, _trips(nest), comps)
    carried = [
        it for k, it in enumerate(iterators)
        if any(v.directions[k] != EQ for v in vectors)
    ]
    if carried:
        return IdiomMatch("recurrence", detail=",".join(carried))

    if len(comps) == 1:
        c = comps[0]
        w_its = {it for ix in c.write.index for it in ix.iterators()}
        red = [it for it in iterators if it in set(c.iterators()) - w_its]
        mult = _is_multiplicative(c.expr, len(c.reads))
        matrix_reads = sum(
            1
            for r in c.reads
            if _single_iter_dims(r) is not None and len(r.index) >= 1
        )
        if c.accumulate == "+" and red and mult is not None and not c.guards:
            out_rank = len(c.write.index)
            if out_rank >= 2 and matrix_reads >= 2:
                return IdiomMatch("blas3", detail=f"red={red}")
            if out_rank == 1:
                return IdiomMatch("blas2", detail=f"red={red}")
            if out_rank == 0:
                return IdiomMatch("dot", detail=f"red={red}")
        if c.accumulate is not None and red:
            return IdiomMatch("reduction")
        # constant-offset reads over the write iterators -> stencil
        offsets = False
        for r in c.reads:
            for ix in r.index:
                if ix.const != 0 and ix.iterators():
                    offsets = True
        if offsets:
            return IdiomMatch("stencil")
        return IdiomMatch("elementwise")
    # multiple computations (fused SCC without carried deps at this level)
    return IdiomMatch("elementwise", detail=f"group={len(comps)}")
