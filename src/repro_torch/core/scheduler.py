"""daisy — the normalized auto-scheduler (paper §4).

Port of ``repro/core/scheduler.py``: ``Daisy.plan`` and ``Daisy.compile``,
plus ``random_inputs`` and ``nest_program``.  Seeding (``Daisy.seed``, the
evolutionary search) and pretuned deployments are not ported yet; a tuning
database written by the reference loads as it is
(``TuningDatabase.load``), since fingerprints are identical.

Pipeline per program:
  1. the compiler pass pipeline: a priori normalization, COFFEE-style
     rewrites and canonical-form re-fusion, memoized in the compilation cache,
  2. per canonical nest: idiom detection,
  3. recipe resolution against the transfer-tuning database
     (exact fingerprint -> embedding nearest-neighbour -> idiom default),
  4. lowering through ``compile_torch`` (CUDA GEMM / Triton nest kernels
     under ``backend='cuda'``, torch ops under ``backend='torch'``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Mapping

import numpy as np
import torch

from .cache import CompilationCache
from .codegen import check_device, compile_torch
from .database import TuningDatabase
from .embedding import embed_nest
from .fusion import optimization_pipeline
from .idioms import classify_nest
from .ir import Computation, Node, Program, fingerprint, nest_computations, program_fingerprint, walk
from .recipes import Recipe
from .search import default_recipe_for, schedule_from_recipe

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
    """

    def __init__(
        self,
        db: TuningDatabase | None = None,
        cache: CompilationCache | None = None,
        fuse: bool = True,
        rewrite: bool = True,
        backend: str = "cuda",
        device: str | torch.device = "cuda",
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
        self.backend = backend
        self.device = check_device(device)
        self.db = db if db is not None else TuningDatabase()
        self.fuse = fuse
        self.rewrite = rewrite
        # shared by plan/compile so database fingerprints always refer to
        # the same canonical form
        self.pipeline = optimization_pipeline(fuse=fuse, rewrite=rewrite)
        # Content-addressed memo for the pipeline -> plan -> compile chain;
        # keys include the database generation, so new recipes expire plans.
        self.cache = cache if cache is not None else CompilationCache()

    def _normalized(self, program: Program, fp: str | None = None) -> Program:
        key = ("pipeline", self.pipeline.name, fp or program_fingerprint(program))
        return self.cache.get_or_build(
            key, lambda: self.pipeline.run(program, cache=self.cache)
        )

    def _plan_key(self, fp: str, normalize_first: bool) -> tuple:
        # db.uid scopes entries to the database instance; generation expires
        # plans resolved against older contents of the same database
        return (fp, normalize_first, self.fuse, self.backend, str(self.device),
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
        per_nest = [schedule_from_recipe(self._backend_recipe(np_.recipe))
                    for np_ in plan.nests]
        result = (compile_torch(plan.program, per_nest, device=self.device), plan)
        self.cache.put(key, result)
        return result
