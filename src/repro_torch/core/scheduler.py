"""daisy — the normalized auto-scheduler (paper §4).

Port of ``repro/core/scheduler.py``: planning and compilation, seeding
(``Daisy.seed``, ``seed_nest``, ``transfer_epoch``) and pretuned deployments
(``Daisy.pretuned``).  Seeding times each candidate on ``Daisy.device``
under the lowering ``compile`` runs for the backend, so under ``'cuda'``
the search launches the nest kernels it times.  A tuning database written
by the reference loads as it is (``TuningDatabase.load``), since
fingerprints are identical.

Pipeline per program:
  1. the compiler pass pipeline: a priori normalization, COFFEE-style
     rewrites and canonical-form re-fusion, memoized in the compilation cache,
  2. per canonical nest: idiom detection,
  3. recipe resolution against the transfer-tuning database
     (exact fingerprint -> embedding nearest-neighbour -> idiom default),
  4. lowering through ``compile_torch`` (CUDA GEMM / Triton nest kernels
     under ``backend='cuda'``, torch ops under ``backend='torch'``).

Seeding (``Daisy.seed``) mirrors the paper: normalize the A variants, give
BLAS-3 nests the library-call recipe directly, run the evolutionary search
for the rest, store recipes keyed by fingerprint + embedding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .cache import CacheStats, CompilationCache
from .codegen import check_device, compile_torch
from .database import TuningDatabase, default_pretuned_path
from .embedding import embed_nest
from .fusion import optimization_pipeline
from .idioms import classify_nest
from .ir import Computation, Node, Program, fingerprint, nest_computations, program_fingerprint, walk
from .passes import PassContext
from .recipes import Recipe
from .search import (
    default_recipe_for,
    evolve_recipe,
    measure_recipe,
    nest_rng_seed,
    schedule_from_recipe,
)

BACKENDS = ("torch", "cuda")


@dataclass
class NestPlan:
    """Scheduling decision for one canonical nest (recipe + its provenance)."""

    fingerprint: str
    idiom: str
    recipe: Recipe
    source: str  # 'exact' | 'transfer(d=..)' | 'default(..)'


@dataclass
class ProgramPlan:
    """The normalized program plus one ``NestPlan`` per canonical nest."""

    program: Program  # normalized
    nests: list[NestPlan]
    # filled by ``Daisy.compile`` under a mesh: the partition planner's
    # whole-program sharding decision (None before compilation / no mesh)
    partition: Any = None

    @property
    def normalized(self) -> bool:
        """Plans are always built from the normalized program."""
        return True


def nest_program(program: Program, nest: Node) -> Program:
    """A standalone single-nest program (used for per-nest measurement).

    Temps the nest *consumes* — reads before it has written them, i.e.
    values produced by earlier nests of the full program — are demoted to
    inputs of the standalone program, so it is never measured on zero-filled
    operands the deployed program never sees.
    """
    arrays = {a.array for _, a in _nest_accesses(nest)}
    temps = set(program.temps) & arrays
    written: set[str] = set()
    consumed: set[str] = set()
    for c in nest_computations(nest):
        for a in c.reads:
            if a.array in temps and a.array not in written:
                consumed.add(a.array)
        # an accumulate write folds into the array's current value — the
        # initial contents are consumed unless this nest wrote them first
        if c.accumulate is not None and c.write.array in temps \
                and c.write.array not in written:
            consumed.add(c.write.array)
        written.add(c.write.array)
    return Program(
        name=f"{program.name}:nest",
        arrays=tuple(a for a in program.arrays if a.name in arrays),
        body=(nest,),
        temps=tuple(t for t in program.temps if t in temps - consumed),
    )


def _nest_accesses(nest: Node):
    if isinstance(nest, Computation):
        for a in nest.accesses():
            yield nest, a
    else:
        for _, c in walk(nest):
            for a in c.accesses():
                yield c, a


def random_inputs(program: Program, seed: int = 0, dtype=np.float32) -> dict[str, np.ndarray]:
    """Uniform(0.1, 1) arrays for every input (non-temp) array."""
    rng = np.random.default_rng(seed)
    return {
        a.name: rng.uniform(0.1, 1.0, size=a.shape).astype(dtype)
        for a in program.input_arrays
    }


class Daisy:
    """The daisy scheduler: normalize, plan recipes per nest, compile.

    ``backend`` is ``'cuda'`` (the counterpart of the reference's
    ``'pallas'``: kernel recipes run the CUDA GEMM and the Triton nest
    kernel) or ``'torch'`` (the counterpart of ``'xla'``: kernel recipes map
    onto their ``einsum``/``vectorize`` equivalents).  ``device`` defaults to
    the card; with no card that raises — pass ``device='cpu'`` to run the
    kernels' plain versions on the CPU.

    ``mesh`` (a ``repro_torch.launch.mesh.Mesh``) turns on the sharded
    execution path: ``compile`` routes the normalized program through the
    partition planner (``repro_torch.core.partition``), which shards each
    canonical nest's outermost parallel iterator across ``mesh``'s
    ``shard_axis`` and falls back to replication wherever the dependence
    oracle vetoes.  A recipe's ``parallelize`` knob overrides the default
    axis per nest.  Recipes are still resolved on the global normalized
    program, so fingerprints never see the shard-local shapes.  Under a mesh
    the program runs on ``mesh.device``.
    """

    def __init__(
        self,
        db: TuningDatabase | None = None,
        cache: CompilationCache | None = None,
        fuse: bool = True,
        rewrite: bool = True,
        backend: str = "cuda",
        device: str | torch.device | None = None,
        mesh: Any = None,
        shard_axis: str = "data",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
        if mesh is not None:
            if shard_axis not in getattr(mesh, "shape", {}):
                raise ValueError(f"the mesh has no axis {shard_axis!r}")
            dev = None if device is None else torch.device(device)
            if dev is not None and (dev.type != mesh.device.type or
                                    dev.index not in (None, mesh.device.index)):
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.backend = backend
        self.device = check_device("cuda" if device is None else device)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.db = db if db is not None else TuningDatabase()
        self.fuse = fuse
        self.rewrite = rewrite
        # shared by plan/compile so database fingerprints always refer to
        # the same canonical form
        self.pipeline = optimization_pipeline(fuse=fuse, rewrite=rewrite)
        # Content-addressed memo for the pipeline -> plan -> compile chain;
        # keys include the database generation, so new recipes expire plans.
        self.cache = cache if cache is not None else CompilationCache()

    @property
    def cache_stats(self) -> CacheStats:
        """Hit/miss counters of the underlying compilation cache."""
        return self.cache.stats

    def _normalized(self, program: Program, fp: str | None = None) -> Program:
        key = ("pipeline", self.pipeline.name, fp or program_fingerprint(program))
        return self.cache.get_or_build(
            key, lambda: self.pipeline.run(program, cache=self.cache)
        )

    def explain(self, program: Program, snapshots: bool = False) -> PassContext:
        """Run the pass pipeline uncached, returning the per-pass context
        (wall time, nest/computation deltas, fusion stats, IR snapshots)."""
        ctx = PassContext(snapshots=snapshots)
        self.pipeline.run(program, ctx=ctx)
        return ctx

    def _plan_key(self, fp: str, normalize_first: bool) -> tuple:
        # db.uid scopes entries to the database instance; generation expires
        # plans resolved against older contents of the same database.  The
        # mesh enters by value (axis names and sizes, the ranks, the device,
        # the shard axis), not identity: two equal meshes address the same
        # compiled fn, while meshes over other ranks stay distinct
        mesh_sig = (tuple(self.mesh.shape.items()), self.mesh.ranks, str(self.mesh.device),
                    self.shard_axis) if self.mesh is not None else None
        return (fp, normalize_first, self.fuse, self.backend, str(self.device), mesh_sig,
                self.db.uid, self.db.generation)

    def _backend_recipe(self, recipe: Recipe) -> Recipe:
        """Map a recipe onto the selected backend: under 'torch' the kernel
        kinds become their torch equivalents (same schedule semantics)."""
        if self.backend == "torch" and recipe.kind.startswith("pallas"):
            kind = "einsum" if recipe.kind == "pallas_gemm" else "vectorize"
            return replace(recipe, kind=kind, tile=None)
        return recipe

    def plan(
        self, program: Program, normalize_first: bool = True, _fp: str | None = None
    ) -> ProgramPlan:
        """Normalize (unless told not to) and resolve a recipe per nest."""
        fp = _fp or program_fingerprint(program)
        key = ("plan",) + self._plan_key(fp, normalize_first)
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        p = self._normalized(program, fp) if normalize_first else program
        plans: list[NestPlan] = []
        for nest in p.body:
            nest_fp = fingerprint(nest)
            emb = embed_nest(p, nest)
            idiom = classify_nest(nest)
            recipe, source = self.db.lookup(nest_fp, emb)
            if recipe is None:
                recipe = default_recipe_for(idiom)
                source = f"default({idiom.kind})"
            plans.append(NestPlan(nest_fp, idiom.kind, recipe, source))
        result = ProgramPlan(p, plans)
        self.cache.put(key, result)
        return result

    def compile(
        self, program: Program, normalize_first: bool = True
    ) -> tuple[Callable[[Mapping[str, np.ndarray]], dict], ProgramPlan]:
        """Plan and lower ``program``; returns (callable, plan), memoized."""
        fp = program_fingerprint(program)
        key = ("compile",) + self._plan_key(fp, normalize_first)
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        plan = self.plan(program, normalize_first=normalize_first, _fp=fp)
        axis = self.shard_axis if self.mesh is not None else None
        per_nest = [schedule_from_recipe(self._backend_recipe(np_.recipe), shard_axis=axis)
                    for np_ in plan.nests]
        if self.mesh is not None:
            from .partition import compile_sharded

            fn, plan.partition = compile_sharded(plan.program, per_nest, mesh=self.mesh,
                                                 axis=self.shard_axis)
        else:
            fn = compile_torch(plan.program, per_nest, device=self.device)
        result = (fn, plan)
        self.cache.put(key, result)
        return result

    # -- seeding (paper: A variants define the database) -----------------------
    def _prepare_nest(self, p: Program, nest: Node, source: str) -> "_SeedItem":
        # one standalone program + one input set per nest, reused by every
        # measurement epoch
        idiom = classify_nest(nest)
        nprog = nest_program(p, nest)
        return _SeedItem(fingerprint(nest), embed_nest(p, nest), idiom.kind,
                         nprog, random_inputs(nprog),
                         default_recipe_for(idiom), source)

    def _measure_item(self, item: "_SeedItem", recipe: Recipe, repeats: int) -> float:
        return measure_recipe(item.nprog, item.inputs, self._backend_recipe(recipe),
                              repeats=repeats, device=self.device)

    def _epoch1_item(
        self, item: "_SeedItem", search: bool, iterations: int,
        population: int, repeats: int, deadline_s: float | None = None,
    ) -> tuple[Recipe, float, str]:
        """Epoch-1 recipe for one nest: BLAS-3 takes the library-call recipe
        directly (paper §4), everything else runs the evolutionary search.
        ``deadline_s`` bounds the search's wall clock (the single BLAS-3
        measurement is not worth budgeting)."""
        if item.idiom == "blas3":
            t = self._measure_item(item, item.seed_recipe, repeats)
            return item.seed_recipe, t, f"{item.source}:idiom"
        return self._search_item(item, search, iterations, population, repeats,
                                 deadline_s=deadline_s)

    def _add_measured(self, item: "_SeedItem", recipe: Recipe,
                      provenance: str, t: float) -> None:
        # a nest whose every candidate was refused (t = inf) ships no entry:
        # plan() falls back to the default recipe at runtime, and the
        # persisted JSON stays free of unvalidated recipes
        if math.isfinite(t):
            self.db.add(item.fingerprint, item.embedding, recipe,
                        provenance=provenance, measured_us=t)

    def _search_item(
        self, item: "_SeedItem", search: bool, iterations: int,
        population: int, repeats: int, deadline_s: float | None = None,
    ) -> tuple[Recipe, float, str]:
        if not search:
            t = self._measure_item(item, item.seed_recipe, repeats)
            return item.seed_recipe, t, f"{item.source}:analytic"
        # candidates are timed as the backend will lower them (under
        # 'torch' no kernel is built or measured; under 'cuda' every kernel
        # candidate is built and launched)
        best, t = evolve_recipe(
            item.nprog, item.inputs, item.seed_recipe,
            iterations=iterations, population=population,
            rng_seed=nest_rng_seed(item.fingerprint),
            resolve=self._backend_recipe,
            device=self.device, repeats=repeats, deadline_s=deadline_s)
        # store what was measured: under 'torch' a kernel-kind winner was
        # timed (and will compile) as its degradation
        return self._backend_recipe(best), t, f"{item.source}:search"

    def _reseed_pool(self, fp: str, emb: np.ndarray, k: int = 10) -> list[Recipe]:
        """Recipes of the most similar *other* nests for the transfer epoch.

        The nest's own database entry (same fingerprint, distance 0) is
        excluded — re-seeding a nest with its own recipe is a no-op that
        would crowd genuinely foreign recipes out of the pool.
        """
        near = self.db.lookup_nearest(emb, k=k + 1)
        return [e.recipe for _, e in near if e.fingerprint != fp][:k]

    def _transfer_item(self, item: "_SeedItem", repeats: int = 3,
                       iterations: int = 1) -> None:
        fp = item.fingerprint
        pool = self._reseed_pool(fp, item.embedding)
        cur = self.db.lookup_exact(fp) or item.seed_recipe
        best, t = evolve_recipe(
            item.nprog, item.inputs, cur, iterations=iterations,
            reseed_pool=pool,
            rng_seed=nest_rng_seed(fp, salt="transfer:"),
            resolve=self._backend_recipe,
            device=self.device, repeats=repeats)
        self._add_measured(item, self._backend_recipe(best),
                           f"{item.source}:search+transfer", t)

    def seed_nest(
        self,
        p: Program,
        nest: Node,
        search: bool = True,
        search_iterations: int = 2,
        population: int = 4,
        repeats: int = 3,
        source: str = "",
        deadline_s: float | None = None,
    ) -> tuple[str, np.ndarray, Recipe, float, str]:
        """Epoch-1 seeding of one canonical nest of a *normalized* program.

        BLAS-3 nests take the library-call recipe directly (paper §4); the
        rest run the evolutionary search.  All timings are taken on
        ``self.device`` under the lowering ``compile`` executes for this
        Daisy's backend.  Does not touch the database — returns
        ``(fingerprint, embedding, recipe, measured_us, provenance)`` so
        callers (``seed``, the tune CLI's pool workers) add or merge the
        result themselves.  ``deadline_s`` bounds the search's wall clock:
        when it expires the best recipe measured so far is returned.
        """
        item = self._prepare_nest(p, nest, source or p.name)
        recipe, t, prov = self._epoch1_item(
            item, search, search_iterations, population, repeats,
            deadline_s=deadline_s)
        return item.fingerprint, item.embedding, recipe, t, prov

    def seed(
        self,
        programs: Sequence[Program],
        search: bool = True,
        search_iterations: int = 2,
        population: int = 4,
        repeats: int = 3,
        verbose: bool = False,
    ) -> None:
        """Tune the database from seed programs (paper: the A variants).

        Canonical nests are deduped across programs, epoch 1 resolves a
        recipe per unique nest (library call for BLAS-3, evolutionary search
        otherwise), and the winners are written back to ``self.db``.
        """
        pending: list[_SeedItem] = []
        seen: set[str] = set()
        for prog in programs:
            p = self._normalized(prog)
            for nest in p.body:
                fp = fingerprint(nest)
                # dedupe against the database AND within this batch:
                # identical canonical nests arising from different variants
                # (the paper's central case) are searched once
                if fp in seen or self.db.lookup_exact(fp) is not None:
                    continue
                seen.add(fp)
                pending.append(self._prepare_nest(p, nest, prog.name))

        # epoch 1: library-call recipe for BLAS-3, evolutionary search else
        for item in pending:
            recipe, t, prov = self._epoch1_item(
                item, search, search_iterations, population, repeats)
            self._add_measured(item, recipe, prov, t)
            if verbose:
                print(f"  seeded {item.fingerprint[:60]} -> {recipe.kind} ({t:.0f}us)")

        # epochs 2-3: re-seed each nest from its most similar nests' recipes
        if search:
            for item in pending:
                if item.idiom == "blas3":
                    continue  # library-call recipes don't join the search
                self._transfer_item(item, repeats=repeats)

    def transfer_epoch(
        self,
        programs: Sequence[Program],
        fingerprints: set[str] | None = None,
        repeats: int = 3,
        iterations: int = 1,
    ) -> int:
        """The paper's 2nd/3rd seeding epochs as a standalone pass: re-seed
        each already-seeded nest of ``programs`` from the recipes of its most
        similar database neighbours (own entry excluded) and keep the
        better-measured winner.  ``fingerprints`` restricts the pass (the
        tune CLI limits it to nests tuned in the current run so incremental
        runs don't re-measure the whole database).  Returns the number of
        nests re-seeded.
        """
        done = 0
        seen: set[str] = set()
        for prog in programs:
            p = self._normalized(prog)
            for nest in p.body:
                fp = fingerprint(nest)
                if fp in seen or self.db.lookup_exact(fp) is None:
                    continue
                if fingerprints is not None and fp not in fingerprints:
                    continue
                seen.add(fp)
                item = self._prepare_nest(p, nest, prog.name)
                if item.idiom == "blas3":
                    continue  # library-call recipes don't join the search
                self._transfer_item(item, repeats=repeats, iterations=iterations)
                done += 1
        return done

    # -- pretuned deployments ---------------------------------------------------
    @classmethod
    def pretuned(
        cls,
        backend: str | None = "cuda",
        path: str | Path | None = None,
        **kwargs,
    ) -> "Daisy":
        """A Daisy warmed with the shipped pretuned transfer-tuning database.

        Loads ``data/pretuned_<backend>.json`` (written by ``python -m
        repro_torch.tools.tune``; directory overridable via
        ``REPRO_PRETUNED_DIR``) so deployments resolve recipes from measured
        tuning data instead of idiom defaults.  ``path`` overrides the
        lookup entirely.  ``backend=None`` resolves to ``'cuda'`` for both
        the database *and* the execution backend — the Daisy must run the
        lowering its recipes were measured under.  ``kwargs`` (``device``
        among them) go to the constructor.
        """
        backend = backend or "cuda"
        p = Path(path) if path is not None else default_pretuned_path(backend)
        return cls(db=TuningDatabase.load(p), backend=backend, **kwargs)


@dataclass
class _SeedItem:
    """Per-nest state shared by every seeding epoch (built once per nest)."""

    fingerprint: str
    embedding: np.ndarray
    idiom: str
    nprog: Program
    inputs: dict[str, np.ndarray]
    seed_recipe: Recipe
    source: str
