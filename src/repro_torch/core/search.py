"""Evolutionary recipe search (paper §4, "Seeding a Scheduling Database").

Port of ``repro/core/search.py``.  The paper seeds candidate optimizations
per nest (an analytical seed here: the idiom-derived recipe plus
perturbations), refines them over a few iterations of mutation + selection
with measured runtime as fitness, and re-seeds from the recipes of the most
similar nests (transfer).

The mutation stream is the reference's, draw for draw: ``_mutate`` draws
from the same presets (``recipes.GEMM/NEST/REDUCE_TILE_PRESETS``) in the same
order, and ``nest_rng_seed`` hashes the same fingerprints, so each nest walks
the reference's candidates.  The nest kernel's planner clamps a preset to
powers of two within ``tiling.MAX_BLOCK_ELEMS``, and K1 ignores the GEMM
tile, so every preset is legal on the card.

Fitness differs from the reference's in what it lets through: a candidate
that the lowering refuses before any launch (``Unsupported``, which a
planner's ``TilingError`` is) or that times to a non-finite value measures
``inf``; an error while building or launching a kernel propagates.
"""
from __future__ import annotations

import math
import random
import time
import zlib
from dataclasses import replace
from typing import Callable, Mapping

import numpy as np
import torch

from .codegen import Schedule, Unsupported, compile_torch
from .idioms import IdiomMatch
from .ir import Program
from .recipes import (
    GEMM_TILE_PRESETS,
    NEST_TILE_PRESETS,
    REDUCE_TILE_PRESETS,
    Recipe,
)
from .util import time_fn

# Candidate measurements taken in this process (the tune CLI reports them).
COUNTS = {"measurements": 0}


def default_recipe_for(idiom: IdiomMatch) -> Recipe:
    """The idiom-keyed fallback recipe when the database has no entry."""
    if idiom.kind in ("blas3",):
        return Recipe(kind="einsum", notes=f"idiom:{idiom.kind}")
    if idiom.kind in ("blas2", "dot"):
        return Recipe(kind="einsum", notes=f"idiom:{idiom.kind}")
    if idiom.kind == "recurrence":
        return Recipe(kind="vectorize", notes="recurrence: carried iterators stay sequential")
    return Recipe(kind="vectorize", notes=f"idiom:{idiom.kind}")


def schedule_from_recipe(recipe: Recipe, shard_axis: str | None = None) -> Schedule:
    """Recipe -> Schedule.  The GEMM recipe's ``tile`` sized TPU blocks and
    has no counterpart (the CUDA GEMM's tiling is fixed); the nest kinds pass
    ``tile`` and ``unroll`` to the nest kernel's planner.  ``shard_axis`` is
    the scheduler-level default mesh axis (``Daisy.shard_axis`` under a
    mesh); the recipe's own ``parallelize`` knob, which the evolutionary
    search may flip, wins when set: an axis name pins the nest to that axis,
    the ``'none'`` sentinel disables sharding for the nest (None defers to
    the default)."""
    axis = recipe.parallelize or shard_axis
    if axis == "none":
        axis = None
    if recipe.kind == "einsum":
        return Schedule(mode="canonical", use_idioms=True, vec_budget=recipe.vec_budget,
                        shard_axis=axis)
    if recipe.kind == "pallas_gemm":
        return Schedule(mode="canonical", use_idioms=True, vec_budget=recipe.vec_budget,
                        pallas_gemm=True, shard_axis=axis)
    if recipe.kind == "pallas_nest":
        return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget,
                        pallas_nest=True, nest_tile=recipe.tile, unroll=recipe.unroll,
                        shard_axis=axis)
    if recipe.kind == "pallas_reduce":
        return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget,
                        pallas_reduce=True, nest_tile=recipe.tile, unroll=recipe.unroll,
                        shard_axis=axis)
    if recipe.kind == "sequential":
        return Schedule(mode="as_written", use_idioms=False, vec_budget=recipe.vec_budget,
                        shard_axis=axis)
    return Schedule(mode="canonical", use_idioms=False, vec_budget=recipe.vec_budget,
                    shard_axis=axis)


def _mutate(recipe: Recipe, rng: random.Random) -> Recipe:
    r = recipe
    roll = rng.random()
    if roll < 0.25:
        r = replace(r, vec_budget=max(1 << 16, min(1 << 24, int(r.vec_budget * rng.choice([0.25, 0.5, 2, 4])))))
    elif roll < 0.45 and r.kind in ("einsum", "vectorize"):
        r = replace(r, kind="vectorize" if r.kind == "einsum" else "einsum")
    elif roll < 0.6:
        # hop into / out of the kernel class.  A kernel recipe on a nest
        # outside its class is sent to the torch lowering by the planner
        # before any launch (counted in ``codegen.ROUTED``), so mis-kinded
        # mutants still measure; selection discards them when slower.
        if r.kind == "vectorize":
            kind = rng.choice(["pallas_nest", "pallas_reduce"])
            presets = NEST_TILE_PRESETS if kind == "pallas_nest" else REDUCE_TILE_PRESETS
            r = replace(r, kind=kind, tile=rng.choice(presets))
        elif r.kind in ("pallas_nest", "pallas_reduce"):
            r = replace(r, kind="vectorize", tile=None)
        elif r.kind == "pallas_gemm":
            r = replace(r, tile=rng.choice(GEMM_TILE_PRESETS))
        elif r.kind == "einsum":
            # library-call reductions can try the tiled in-kernel reduction
            r = replace(r, kind="pallas_reduce", tile=rng.choice(REDUCE_TILE_PRESETS))
        else:  # 'sequential': the only remaining hop is back to vectorize
            r = replace(r, kind="vectorize", tile=None)
    elif roll < 0.85 and r.kind in ("pallas_nest", "pallas_reduce", "pallas_gemm"):
        presets = {"pallas_nest": NEST_TILE_PRESETS,
                   "pallas_reduce": REDUCE_TILE_PRESETS,
                   "pallas_gemm": GEMM_TILE_PRESETS}[r.kind]
        r = replace(r, tile=rng.choice(presets))
    elif roll < 0.95:
        r = replace(r, unroll=rng.choice([1, 2, 4]))
    else:
        # cycle the mesh-axis knob (None = scheduler default, 'none' =
        # sharding off for this nest, 'data' = pin); read by
        # ``schedule_from_recipe`` under a mesh (``Daisy(mesh=)``)
        cycle = {None: "data", "data": "none", "none": None}
        r = replace(r, parallelize=cycle.get(r.parallelize))
    return r


def nest_rng_seed(fingerprint: str, salt: str = "") -> int:
    """Deterministic per-nest RNG seed for the evolutionary search.

    Every nest gets its own mutation stream (a shared fixed seed would walk
    the identical mutation sequence for every nest in a batch), stable across
    runs and processes so tuning is reproducible.
    """
    return zlib.crc32(f"{salt}{fingerprint}".encode()) & 0x7FFFFFFF


def measure_recipe(
    nest_program: Program,
    inputs: Mapping[str, np.ndarray],
    recipe: Recipe,
    repeats: int = 3,
    device: str | torch.device = "cuda",
) -> float:
    """Median time (us) of one nest lowered under ``recipe`` on ``device``.

    The inputs are put on the device once, before timing, so the fitness is
    the nest's run and not a host-to-device copy (the reference's jitted
    call transfers its numpy inputs on every call).  On the card each run is
    timed between CUDA events (``util.time_fn``); the first, untimed run
    builds the kernel.

    Returns ``inf`` only for a candidate the lowering refuses before any
    launch (``Unsupported``, a planner's ``TilingError`` included) and for a
    non-finite time, so neither can win selection.  An error while building
    or launching a kernel propagates: the reference turns any exception into
    ``inf``, which would hide a broken kernel behind a slower recipe.
    """
    COUNTS["measurements"] += 1
    dev = torch.device(device)
    try:
        fn = compile_torch(nest_program, schedule_from_recipe(recipe), device=dev)
        args = {k: torch.as_tensor(np.asarray(v, dtype=np.float32)).to(dev)
                for k, v in inputs.items()}
        t = time_fn(lambda: fn(args), repeats=repeats, device=dev)
    except Unsupported:
        return float("inf")
    return t if math.isfinite(t) else float("inf")


def evolve_recipe(
    nest_program: Program,
    inputs: Mapping[str, np.ndarray],
    seed_recipe: Recipe,
    iterations: int = 3,
    population: int = 4,
    rng_seed: int = 0,
    reseed_pool: list[Recipe] | None = None,
    resolve: Callable[[Recipe], Recipe] | None = None,
    device: str | torch.device = "cuda",
    repeats: int = 3,
    deadline_s: float | None = None,
) -> tuple[Recipe, float]:
    """Mutation+selection over recipes, runtime fitness (paper's epochs).

    ``reseed_pool`` models the paper's 2nd/3rd epochs: recipes of the most
    similar nests (by embedding distance) join the population.

    ``resolve`` (e.g. ``Daisy._backend_recipe``) maps each candidate onto
    the lowering the deployment backend will actually run before timing it,
    so fitness measures what ``compile()`` later executes — under the
    'torch' backend kernel-kind mutants are timed as their vectorize/einsum
    degradations and no kernel is ever built.

    ``deadline_s`` is a wall-clock budget: when it expires mid-search the
    best recipe measured *so far* is returned.  The budget changes only when
    measurement stops, never what is mutated: a run that finishes under its
    deadline walks the identical RNG sequence as an unbounded one.
    """
    rng = random.Random(rng_seed)
    deadline = (time.monotonic() + deadline_s) if deadline_s is not None else None

    def out_of_time() -> bool:
        """Whether the wall-clock deadline (if any) has expired."""
        return deadline is not None and time.monotonic() >= deadline

    pop = [seed_recipe] + [_mutate(seed_recipe, rng) for _ in range(population - 1)]
    if reseed_pool:
        pop.extend(reseed_pool[: population // 2])

    # Recipes are frozen (hashable) values: each candidate is timed once,
    # not again every iteration it survives.
    timed: dict[Recipe, float] = {}

    def fitness(r: Recipe) -> float:
        """Memoized time of one candidate recipe (lower is better)."""
        key = resolve(r) if resolve is not None else r
        if key not in timed:
            timed[key] = measure_recipe(nest_program, inputs, key, repeats=repeats,
                                        device=device)
        return timed[key]

    best, best_t = seed_recipe, fitness(seed_recipe)
    for _ in range(iterations):
        if out_of_time():
            break
        scored = []
        for r in pop:
            scored.append((fitness(r), r))
            if out_of_time():
                break
        scored.sort(key=lambda t: t[0])
        if scored and scored[0][0] < best_t:
            best_t, best = scored[0]
        if len(scored) < len(pop):
            break  # deadline cut this iteration short: keep the partial best
        survivors = [r for _, r in scored[: max(2, population // 2)]]
        pop = survivors + [_mutate(rng.choice(survivors), rng) for _ in range(population - len(survivors))]
    return best, best_t
