"""Optimization recipes — what the transfer-tuning database stores per nest.

Port of ``repro/core/recipes.py``: a copy; its code differs only in import roots.

A recipe is the downstream half of the paper's pipeline: after normalization
maps a nest to canonical form, the recipe says how to lower it.  Recipes are
deliberately small — that is the point of the paper: normalization collapses
the input space so a handful of recipes covers many programs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Recipe:
    """Lowering decisions for one canonical nest.

    kind:
      'einsum'        — BLAS-class idiom: dispatch to torch.einsum (library call)
      'pallas_gemm'   — same idiom, routed to the CUDA GEMM kernel (K1)
      'pallas_nest'   — grid-tiled nest kernel for fully-parallel nests
                        (elementwise/stencil groups; tiling planner partitions
                        the parallel iterators into a VPU-aligned grid)
      'pallas_reduce' — grid-tiled nest kernel for associative reductions
                        (innermost reduction iterator becomes an 'arbitrary'
                        grid dim accumulated through VMEM scratch; ``unroll``
                        splits the in-tile reduction into sequential chunks)
      'vectorize'     — generic vectorized lowering of all legal iterators
      'sequential'    — keep sequential loops (recurrences; the safe fallback)

    The kind names are the reference's (they are database keys); the port
    runs the ``pallas_*`` kinds on its Hopper kernels.  ``tile`` is the
    block-size tuple: ``(bm, bn, bk)`` (unused by the port's GEMM) for
    'pallas_gemm'; for 'pallas_nest'/'pallas_reduce' it is assigned to the
    *innermost* parallel axes (with the reduction tile last for
    'pallas_reduce') and the planner clamps it to the nest's extents.
    """

    kind: str = "vectorize"
    vec_budget: int = 1 << 22          # materialization budget (elements)
    tile: tuple[int, ...] | None = None  # kernel block sizes (see docstring)
    # mesh axis for the outer parallel loop: an axis name pins the nest to
    # that axis, 'none' disables sharding, None defers to the scheduler's
    # default (Daisy.shard_axis under a mesh)
    parallelize: str | None = None
    unroll: int = 1                    # reduction unroll factor
    notes: str = ""

    def to_json(self) -> dict[str, Any]:
        """JSON-serializable dict form (tile tuple becomes a list)."""
        d = dataclasses.asdict(self)
        d["tile"] = list(self.tile) if self.tile else None
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Recipe":
        """Rebuild a ``Recipe`` from its ``to_json`` form."""
        d = dict(d)
        if d.get("tile"):
            d["tile"] = tuple(d["tile"])
        return Recipe(**d)


DEFAULT_RECIPE = Recipe(kind="vectorize")

# The reference's MXU-aligned tile presets for the Pallas GEMM (multiples of (8,128)); the
# evolutionary search mutates within this set.
GEMM_TILE_PRESETS: tuple[tuple[int, int, int], ...] = (
    (128, 128, 128),
    (256, 128, 128),
    (128, 256, 128),
    (256, 256, 128),
    (512, 128, 128),
    (128, 128, 256),
    (512, 256, 128),
    (256, 256, 256),
)

# VPU-aligned tile presets for the grid-tiled nest kernel: (sublane, lane)
# pairs — multiples of (8, 128) for fp32 — plus lane-only presets for rank-1
# nests.  Assigned to the innermost parallel axes; the planner clamps each
# entry to the axis extent, so one preset set serves every canonical shape.
NEST_TILE_PRESETS: tuple[tuple[int, ...], ...] = (
    (8, 128),
    (16, 128),
    (32, 128),
    (8, 256),
    (16, 256),
    (64, 128),
    (8, 512),
    (128,),
    (512,),
    (1024,),
)

# For 'pallas_reduce' the last element is the reduction-axis tile (the
# 'arbitrary' grid dimension accumulated through VMEM scratch).
REDUCE_TILE_PRESETS: tuple[tuple[int, ...], ...] = (
    (8, 128, 128),
    (16, 128, 128),
    (8, 256, 128),
    (8, 128, 256),
    (32, 128, 128),
    (8, 128, 512),
    (128, 128),
    (256, 128),
)
