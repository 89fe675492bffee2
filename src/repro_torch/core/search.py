"""Recipe -> schedule resolution (the part of the search that compile needs).

Port of ``repro/core/search.py``: ``default_recipe_for`` and
``schedule_from_recipe``.  The evolutionary search (``evolve_recipe``,
``measure_recipe``) is not ported yet.
"""
from __future__ import annotations

from .codegen import Schedule
from .idioms import IdiomMatch
from .recipes import Recipe


def default_recipe_for(idiom: IdiomMatch) -> Recipe:
    """The idiom-keyed fallback recipe when the database has no entry."""
    if idiom.kind in ("blas3",):
        return Recipe(kind="einsum", notes=f"idiom:{idiom.kind}")
    if idiom.kind in ("blas2", "dot"):
        return Recipe(kind="einsum", notes=f"idiom:{idiom.kind}")
    if idiom.kind == "recurrence":
        return Recipe(kind="vectorize", notes="recurrence: carried iterators stay sequential")
    return Recipe(kind="vectorize", notes=f"idiom:{idiom.kind}")


def schedule_from_recipe(recipe: Recipe) -> Schedule:
    """Recipe -> Schedule.  The GEMM recipe's ``tile`` sized TPU blocks and
    has no counterpart (the CUDA GEMM's tiling is fixed); the nest kinds pass
    ``tile`` and ``unroll`` to the nest kernel's planner."""
    if recipe.kind == "einsum":
        return Schedule(mode="canonical", use_idioms=True, vec_budget=recipe.vec_budget)
    if recipe.kind == "pallas_gemm":
        return Schedule(mode="canonical", use_idioms=True, vec_budget=recipe.vec_budget,
                        pallas_gemm=True)
    if recipe.kind == "pallas_nest":
        return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget,
                        pallas_nest=True, nest_tile=recipe.tile, unroll=recipe.unroll)
    if recipe.kind == "pallas_reduce":
        return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget,
                        pallas_reduce=True, nest_tile=recipe.tile, unroll=recipe.unroll)
    if recipe.kind == "sequential":
        return Schedule(mode="as_written", use_idioms=False, vec_budget=recipe.vec_budget)
    return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget)
