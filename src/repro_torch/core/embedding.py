"""Performance embeddings of canonical loop nests (paper §4, citing [33]).

Port of ``repro/core/embedding.py``: a copy that changes only its import roots.

The transfer-tuning database is queried by Euclidean distance between these
fixed-length feature vectors.  Features capture exactly what the recipes are
sensitive to: nest shape (depth/trip counts), access structure (stride
profile, reuse), and compute/data volume (arithmetic intensity).
"""
from __future__ import annotations

import math

import numpy as np

from .dependence import EQ, nest_direction_vectors
from .ir import Computation, Loop, Node, Program, loop_iterators, nest_computations
from .normalize import access_stride

DIM = 24
_MAX_DEPTH = 6


def embed_nest(program: Program, nest: Node) -> np.ndarray:
    """Structural feature vector (length ``DIM``) for one canonical nest.

    Features: depth/computation/read/guard counts, carried and reduction
    iterator counts, log-scaled trip counts, per-level stride profile, and
    log flops/footprint/intensity.  Keys the tuning database's
    nearest-neighbour transfer, so the layout is checked at runtime.
    """
    if isinstance(nest, Computation):
        comps: list[Computation] = [nest]
        iterators: list[str] = []
        trips: dict[str, int] = {}
    else:
        comps = nest_computations(nest)
        iterators = list(loop_iterators(nest))
        trips = {}

        def rec(n: Node) -> None:
            """Collect trip counts from every loop in the nest."""
            if isinstance(n, Loop):
                trips[n.iterator] = n.trip_count
                for b in n.body:
                    rec(b)

        rec(nest)

    depth = len(iterators)
    log_trips = sorted((math.log2(max(1, trips[i])) for i in iterators), reverse=True)
    log_trips = (log_trips + [0.0] * _MAX_DEPTH)[:_MAX_DEPTH]

    n_reads = sum(len(c.reads) for c in comps)
    n_acc = sum(1 for c in comps if c.accumulate is not None)
    n_guard = sum(len(c.guards) for c in comps)

    # stride profile: per nest level (inner->outer) the paper's criterion
    stride_prof = []
    for it in reversed(iterators):
        s = sum(access_stride(program, a, it) for c in comps for a in c.accesses())
        stride_prof.append(math.log1p(s))
    stride_prof = (stride_prof + [0.0] * _MAX_DEPTH)[:_MAX_DEPTH]

    # parallel vs reduction/carried iterators
    vectors = nest_direction_vectors(iterators, trips, comps) if iterators else []
    carried = sum(
        1
        for k, _ in enumerate(iterators)
        if any(v.directions[k] != EQ for v in vectors)
    )
    red = sum(
        1
        for it in iterators
        if any(
            it not in set(x for ix in c.write.index for x in ix.iterators())
            and it in c.iterators()
            for c in comps
        )
    )

    iters_total = math.prod(max(1, trips[i]) for i in iterators) if iterators else 1
    flops = iters_total * max(1, n_reads)
    footprint = sum(
        program.array(name).size
        for name in {a.array for c in comps for a in c.accesses()}
    )
    intensity = flops / max(1, footprint)

    vec = np.array(
        [depth, len(comps), n_reads, n_acc, n_guard, carried, red,
         math.log1p(flops), math.log1p(footprint), math.log1p(intensity)]
        + log_trips
        + stride_prof,
        dtype=np.float64,
    )
    # Explicit check (not ``assert``: embeddings key the persisted database,
    # so a layout drift must fail loudly even under ``python -O``).
    if vec.shape != (10 + 2 * _MAX_DEPTH,) or DIM != 10 + 2 * _MAX_DEPTH + 2:
        raise RuntimeError(
            f"embedding layout out of sync: {vec.shape[0]} features with "
            f"_MAX_DEPTH={_MAX_DEPTH} but DIM={DIM}; update DIM when the "
            "feature set changes"
        )
    return np.concatenate([vec, [0.0, 0.0]])  # reserved slots


def distance(a: np.ndarray, b: np.ndarray) -> float:
    """Euclidean distance between two nest embeddings."""
    return float(np.linalg.norm(a - b))
