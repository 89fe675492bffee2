"""Shared autotune core: one search/measurement machine for offline tuning
(the tune CLI) and online adaptive tuning in deployment.

Port of ``repro/autotune.py``.  Offline half:

  * :func:`program_specs` / :func:`build_program` — registry coordinates of
    tunable programs, rebuildable inside spawn workers (IR computations
    hold lambdas, which do not pickle); ``source='import'`` names a
    deployment-defined program as ``"module:function"``;
  * :func:`tune_nest_task` — the per-nest epoch-1 search worker, which
    times candidates on the task's ``device``;
  * :func:`run_supervised` — the supervised pool: per-task progress
    timeouts, bounded retries with solo-isolation crash forensics, and
    fingerprint-keyed quarantine, over either an in-process queue
    (``jobs <= 1``) or a spawn ``ProcessPoolExecutor``.

Online half (the Performance-Embeddings deployment story: transfer *at
deployment*, not just offline):

  * :class:`NestTelemetry` — per-key EMA wall times observed from real
    ``ServingEngine.step()`` calls, keyed by program fingerprint; a
    disabled instance is a no-op so tuner-less deployments pay nothing;
  * :func:`logit_pipeline_program` — the six-stage per-decode-step logit
    nest, written as ``Expr`` trees so the nest kernel (K2) can generate
    its body; its fingerprint is the reference's;
  * :class:`SearchSupervisor` — launches :func:`online_search_task`
    searches (``evolve_recipe`` under a wall-clock ``deadline_s``) on the
    hottest registered programs through the same supervised pool, then
    applies the :class:`SwapPolicy`: a candidate must beat the incumbent
    by a configurable margin AND validate through
    ``fault.compile_with_degradation`` (compile + run once per backend
    rung, ``cuda -> torch``) before it is committed to the live
    :class:`TuningDatabase` — whose ``generation`` bump is what hot-swaps
    the engine's step functions (their cache keys carry
    ``(db.uid, db.generation)``);
  * automatic **rollback**: each swap arms a telemetry watch; if the
    post-swap EMA regresses beyond ``rollback_ratio`` within
    ``rollback_window`` observations, the incumbent entry is restored
    verbatim (another generation bump) and the nest is quarantined;
  * :meth:`SearchSupervisor.fold_back` — winners merge into the deployment
    database file via atomic checksummed ``merge()`` + ``save()`` so the
    fleet learns across restarts.

On the card, workers that time at once share it and corrupt each other's
fitness: tune on one card with ``jobs=1`` (``spawn`` mode refuses more on a
CUDA device).  A sticky CUDA error (an illegal address) leaves the process
unable to launch anything else, so it ends an in-process run and kills a
pool worker (which the pool then treats as a crash) instead of being
retried in the same process.  A poison candidate cannot take down serving:
worker errors are retried then quarantined, and nothing reaches the live
database without an executed validation.

The telemetry -> search -> swap lifecycle, end to end::

    from repro_torch.autotune import SearchSupervisor, SwapPolicy, logit_pipeline_program

    prog = logit_pipeline_program(vocab=cfg.vocab, slots=8)
    sup = SearchSupervisor(db, mode="thread", policy=SwapPolicy(margin=0.1))
    eng = ServingEngine(cfg, params, scfg, tuner=sup,
                        logit_program=prog, logit_inputs={"B": bias})
    while serving:
        eng.step()          # times each busy step into sup.telemetry and
                            # drives maybe_launch()/poll() periodically
    sup.fold_back("fleet.json")                      # winners persist
"""
from __future__ import annotations

import hashlib
import importlib
import math
import multiprocessing
import os
import queue
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch

from .core import Daisy, Program, TuningDatabase, fingerprint, program_fingerprint
from .core import search
from .core.database import Entry
from .core.ir import Array, Computation, Loop, Read, acc, emax, emin
from .core.recipes import Recipe
from .fault import FaultInjected, FaultPlan, RestartPolicy

SUITES = ("polybench", "cloudsc", "all")
BACKENDS = ("torch", "cuda")


# ---------------------------------------------------------------------------
# program registry coordinates (CLI tasks rebuild programs from coordinates
# instead of pickling IR)
# ---------------------------------------------------------------------------

def program_specs(suite: str, names: list[str] | None = None) -> list[tuple[str, str]]:
    """(source, name) coordinates of every program the suite tunes."""
    specs: list[tuple[str, str]] = []
    if suite in ("polybench", "all"):
        from .polybench import BENCHMARKS

        sel = names or list(BENCHMARKS)
        unknown = [n for n in sel if n not in BENCHMARKS]
        if unknown:
            raise SystemExit(
                f"unknown benchmark(s) {', '.join(unknown)}; "
                f"valid: {', '.join(BENCHMARKS)}"
            )
        specs += [("polybench", n) for n in sel]
    if suite in ("cloudsc", "all"):
        specs += [("cloudsc", "erosion"), ("cloudsc", "scheme")]
    return specs


def build_program(source: str, name: str, size: str = "mini",
                  kwargs: dict | None = None) -> Program:
    """Rebuild a program from its registry coordinates (IR computations hold
    lambdas, which do not pickle — workers reconstruct instead of receiving).

    ``source='import'`` resolves ``name`` as ``"module:function"`` and calls
    it with ``kwargs`` — how deployment-defined programs (e.g. an engine's
    logit pipeline) become addressable from spawn workers.
    """
    if source == "import":
        mod, _, fn = name.partition(":")
        if not mod or not fn:
            raise ValueError(
                f"source='import' needs name='module:function', got {name!r}")
        return getattr(importlib.import_module(mod), fn)(**(kwargs or {}))
    if source == "polybench":
        from .polybench import BENCHMARKS

        return BENCHMARKS[name].make("a", size)
    from .cloudsc import erosion_program, mini_cloudsc_program

    nproma, klev = (128, 137) if size == "bench" else (8, 5)
    if name == "erosion":
        return erosion_program(nproma=nproma, klev=4 if size == "mini" else klev)
    return mini_cloudsc_program(nproma=nproma, klev=klev)


def task_key(fp: str) -> str:
    """Filesystem-safe id for a nest fingerprint (started-marker filename)."""
    return hashlib.md5(fp.encode()).hexdigest()


def _task_program(task: dict) -> Program:
    """The task's program: carried directly (in-process modes) or rebuilt
    from registry coordinates (spawn workers)."""
    prog = task.get("program")
    if prog is not None:
        return prog
    return build_program(task["source"], task["name"], task.get("size", "mini"),
                         kwargs=task.get("builder_kwargs"))


def _worker_preamble(task: dict) -> None:
    """Started marker + injected-fault execution."""
    scratch = task.get("scratch")
    if scratch:
        # started marker: if this worker dies, the supervisor can tell the
        # tasks that were actually running from the ones the pool never got
        # to (only the former are charged a retry attempt)
        (Path(scratch) / task_key(task["fingerprint"])).touch()
    fault = task.get("fault")  # injected by the parent's FaultPlan
    if fault == "crash":
        os._exit(3)  # hard kill, like a segfaulting kernel build
    if fault == "hang":
        time.sleep(float(task.get("hang_s", 3600.0)))
    if fault == "error":
        raise FaultInjected(
            f"injected worker error for {task['name']} nest {task['nest_index']}")


def _device_lost(task: dict) -> bool:
    """Whether the task's card is unusable after an error: a sticky CUDA
    error (an illegal address, say) fails every later call in the process,
    so the synchronize below raises it again."""
    if torch.device(task.get("device", "cpu")).type != "cuda":
        return False
    try:
        torch.cuda.synchronize()
    except RuntimeError:
        return True
    return False


def tune_nest_task(task: dict) -> dict:
    """Pool worker: epoch-1 search for one canonical nest on ``task['device']``.

    Rebuilds and re-normalizes the program — the pass pipeline is
    deterministic, so ``nest_index`` addresses the same canonical nest the
    parent enumerated (the fingerprint check below enforces it).
    """
    _worker_preamble(task)
    try:
        d, p, nest = _task_nest(task)
        before = search.COUNTS["measurements"]
        fp, emb, recipe, t, prov = d.seed_nest(
            p, nest, search=task["search"], search_iterations=task["iterations"],
            population=task["population"], repeats=task["repeats"],
            deadline_s=task.get("deadline_s"),
        )
        measured = search.COUNTS["measurements"] - before
    except Exception:
        _exit_if_device_lost(task)
        raise
    return {"fingerprint": fp, "embedding": np.asarray(emb).tolist(),
            "recipe": recipe.to_json(), "measured_us": t, "provenance": prov,
            "measurements": measured}


def _task_nest(task: dict):
    """(Daisy on the task's device, normalized program, the task's nest).
    The pass pipeline is deterministic, so ``nest_index`` addresses the nest
    the parent enumerated; the fingerprint check enforces it before the
    search burns its compile+measure budget."""
    d = Daisy(backend=task["backend"], device=task.get("device", "cuda"))
    p = d._normalized(_task_program(task))
    nest = p.body[task["nest_index"]]
    if fingerprint(nest) != task["fingerprint"]:
        raise RuntimeError(
            f"normalization diverged between parent and worker for "
            f"{task['name']} nest {task['nest_index']}"
        )
    return d, p, nest


def _exit_if_device_lost(task: dict) -> None:
    """A pool worker that can no longer launch dies as a crash."""
    if multiprocessing.parent_process() is not None and _device_lost(task):
        os._exit(4)


def online_search_task(task: dict) -> dict:
    """Pool worker for one *online* search on ``task['device']``: measure the
    incumbent recipe, then run the deadline-bounded epoch-1 search — both
    under the lowering the deployment backend executes — and report
    candidate vs incumbent.

    The same supervision (started markers, injected faults, retries,
    quarantine) applies as to :func:`tune_nest_task`; the extra fields in
    the result (``incumbent_us``, ``incumbent``, ``program_key``) feed the
    :class:`SwapPolicy` decision in the parent.

    Under ``backend='cuda'`` the nest kernel of the nest's class
    (``kernel_candidate``) is measured beside the search's winner and taken
    when faster (``kernel_us`` in the result; provenance ``...:kernel``).
    The reference's search reaches a kernel kind only by one mutation hop
    out of ``vectorize``, which its seeded stream may never draw within a
    small online budget: at the logit nest (vocab 32,000 x 8 slots) one
    iteration of populations up to 12 never tries ``pallas_nest``.
    """
    _worker_preamble(task)
    try:
        d, p, nest = _task_nest(task)
        item = d._prepare_nest(p, nest, source=f"online:{task['name']}")
        inc = (Recipe.from_json(task["incumbent"]) if task.get("incumbent")
               else item.seed_recipe)
        repeats = int(task.get("repeats", 3))
        before = search.COUNTS["measurements"]
        incumbent_us = d._measure_item(item, inc, repeats)
        recipe, t, prov = d._epoch1_item(
            item, True, int(task.get("iterations", 2)),
            int(task.get("population", 4)), repeats,
            deadline_s=task.get("deadline_s"))
        kernel = kernel_candidate(item.nprog, d.backend) if item.idiom != "blas3" else None
        kernel_us = None
        if kernel is not None and kernel != recipe:
            kernel_us = d._measure_item(item, kernel, repeats)
            if kernel_us < t:
                recipe, t, prov = kernel, kernel_us, f"{item.source}:kernel"
        measured = search.COUNTS["measurements"] - before
    except Exception:
        _exit_if_device_lost(task)
        raise
    return {"fingerprint": item.fingerprint,
            "embedding": np.asarray(item.embedding).tolist(),
            "recipe": recipe.to_json(), "measured_us": t, "provenance": prov,
            "incumbent": inc.to_json(), "incumbent_us": incumbent_us,
            "kernel_us": kernel_us,
            "name": task["name"], "nest_index": task["nest_index"],
            "program_key": task.get("program_key", ""), "measurements": measured}


def kernel_candidate(nprog: Program, backend: str) -> Recipe | None:
    """The nest kernel recipe of a single-nest program's class under
    ``backend='cuda'`` (``pallas_nest`` for a parallel nest, ``pallas_reduce``
    for a reduction), or None: under ``'torch'``, or for a nest outside
    the tiled class."""
    from .core.tiling import TilingError, plan_nest_tiling

    if backend != "cuda":
        return None
    try:
        plan = plan_nest_tiling(nprog, nprog.body[0])
    except TilingError:
        return None
    return Recipe(kind="pallas_nest" if plan.kind == "parallel" else "pallas_reduce")


class PoolStall(RuntimeError):
    """No task completed within the progress timeout — workers presumed hung."""


def run_supervised(
    tasks: list[dict],
    jobs: int,
    verbose: bool,
    on_result=None,
    task_timeout_s: float | None = None,
    max_task_retries: int = 1,
    fault_plan: FaultPlan | None = None,
    worker=tune_nest_task,
) -> tuple[list[dict], dict[str, str]]:
    """Run per-nest searches under supervision.

    Returns ``(results, quarantined)`` where ``quarantined`` maps nest
    fingerprints that exhausted their retries to a reason string.
    ``on_result(task, result)`` fires as each nest lands (checkpoint hook).
    ``worker`` is the task function (:func:`tune_nest_task` offline,
    :func:`online_search_task` for deployment searches) — it must be a
    module-level callable so the spawn pool can pickle it.
    """
    results: list[dict] = []
    quarantined: dict[str, str] = {}
    policies: dict[str, RestartPolicy] = {}

    def policy(fp: str) -> RestartPolicy:
        return policies.setdefault(fp, RestartPolicy(max_restarts=max_task_retries))

    def emit(t: dict, r: dict) -> None:
        results.append(r)
        if on_result is not None:
            on_result(t, r)
        if verbose:
            print(f"  [{len(results)}/{len(tasks)}] {t['name']} "
                  f"nest {t['nest_index']} -> {r['recipe']['kind']} "
                  f"({r['measured_us']:.0f}us)", flush=True)

    def charge(t: dict, exc: BaseException) -> bool:
        """One failed attempt: True -> retry, False -> quarantined."""
        fp = t["fingerprint"]
        if policy(fp).should_restart(exc):
            if verbose:
                print(f"  retry {t['name']} nest {t['nest_index']} "
                      f"(attempt {policies[fp].restarts + 1}): {exc}", flush=True)
            return True
        quarantined[fp] = (f"{t['name']} nest {t['nest_index']}: {exc} "
                           f"(after {policies[fp].restarts} attempt(s))")
        if verbose:
            print(f"  QUARANTINED {t['name']} nest {t['nest_index']}: {exc}",
                  flush=True)
        return False

    def consult(t: dict) -> dict:
        """Parent-side fault-plan consult: embed a picklable fault kind
        (dropping any stale kind from a previous attempt — a consumed fault
        must not replay on the retry)."""
        t = {k: v for k, v in t.items() if k != "fault"}
        if fault_plan is None:
            return t
        f = fault_plan.fire("tune.worker", key=t["fingerprint"])
        if f is not None:
            t["fault"] = f.kind
        return t

    if jobs <= 1 or len(tasks) <= 1:
        # in-process path: worker-kill faults cannot be executed literally
        # (they would kill the run itself) — every injected kind raises and
        # goes through the same retry/quarantine accounting
        todo = deque(tasks)
        while todo:
            t = consult(todo.popleft())
            try:
                if t.get("fault"):
                    raise FaultInjected(
                        f"injected {t['fault']} for {t['name']} "
                        f"nest {t['nest_index']}")
                r = worker(t)
            except Exception as e:  # noqa: BLE001 — supervised retry
                if _device_lost(t):
                    raise  # nothing more can be measured in this process
                if charge(t, e):
                    todo.append(t)
                continue
            emit(t, r)
        return results, quarantined

    # spawn, not fork: CUDA does not survive a fork, and a forked torch's
    # thread pools can deadlock
    ctx = get_context("spawn")
    remaining = list(tasks)
    # a pool-wide breakage cannot name its culprit: every started task in
    # the round is a suspect.  Suspects re-run SOLO (one per round) so the
    # next crash charges exactly the poison nest and co-started innocents
    # succeed instead of being quarantined by association.
    suspects: deque[dict] = deque()
    with tempfile.TemporaryDirectory(prefix="repro-torch-tune-") as scratch:
        while remaining or suspects:
            if suspects:
                src = [suspects.popleft()]
            else:
                src, remaining = remaining, []
            round_tasks = []
            for t in src:
                t = consult(dict(t, scratch=scratch))
                (Path(scratch) / task_key(t["fingerprint"])).unlink(missing_ok=True)
                round_tasks.append(t)
            lost: list[dict] = []
            broken: BaseException | None = None
            ex = ProcessPoolExecutor(max_workers=min(jobs, len(round_tasks)),
                                     mp_context=ctx)
            futs = {ex.submit(worker, t): t for t in round_tasks}
            pending = set(futs)
            try:
                while pending:
                    done, pending = wait(pending, timeout=task_timeout_s,
                                         return_when=FIRST_COMPLETED)
                    if not done:
                        raise PoolStall(
                            f"no task completed within {task_timeout_s}s — "
                            f"killing {len(pending)} in-flight worker(s)")
                    for f in done:
                        t = futs[f]
                        try:
                            r = f.result()
                        except BrokenProcessPool as e:
                            broken = e
                            lost.append(t)
                            continue
                        except Exception as e:  # noqa: BLE001 — worker raised
                            if charge(t, e):
                                remaining.append(t)
                            continue
                        emit(t, r)
                    if broken is not None:
                        raise broken
            except (BrokenProcessPool, PoolStall) as e:
                broken = e
                lost.extend(futs[f] for f in pending)
                # hung/orphaned workers never exit on their own — kill them
                # so shutdown does not block behind a sleeping process
                for p in list(getattr(ex, "_processes", {}).values()):
                    try:
                        p.terminate()
                    except Exception:  # noqa: BLE001
                        pass
                ex.shutdown(wait=False, cancel_futures=True)
            else:
                ex.shutdown()
            if broken is not None:
                started = [t for t in lost
                           if (Path(scratch) / task_key(t["fingerprint"])).exists()]
                never_started = [t for t in lost if t not in started]
                if not started:
                    # nothing even began before the pool died: the pool
                    # itself is the problem, not a poison task — charge
                    # everyone so a permanently-broken pool still terminates
                    started, never_started = never_started, []
                for t in started:
                    if charge(t, broken):
                        suspects.append(t)
                remaining.extend(never_started)
                if verbose:
                    print(f"  pool lost ({broken}); salvaged {len(results)} "
                          f"result(s), {len(suspects)} suspect(s) to isolate, "
                          f"{len(remaining)} task(s) requeued", flush=True)
    return results, quarantined


# ---------------------------------------------------------------------------
# live telemetry
# ---------------------------------------------------------------------------

@dataclass
class NestStat:
    ema_s: float = 0.0
    count: int = 0
    total_s: float = 0.0
    last_s: float = 0.0


class NestTelemetry:
    """Per-key EMA wall times from real deployment steps.

    Keys are program fingerprints or free-form labels.  A disabled instance
    returns from ``observe`` before touching any state, so the telemetry hook
    in a tuner-less engine costs one predicate per step.  All methods run on
    the observing (serving) thread; no lock is needed.
    """

    def __init__(self, alpha: float = 0.25, enabled: bool = True):
        self.alpha = float(alpha)
        self.enabled = bool(enabled)
        self._stats: dict[str, NestStat] = {}

    def observe(self, key: str, seconds: float) -> None:
        if not self.enabled:
            return
        s = self._stats.get(key)
        if s is None:
            s = self._stats[key] = NestStat(ema_s=float(seconds))
        else:
            s.ema_s += self.alpha * (float(seconds) - s.ema_s)
        s.count += 1
        s.total_s += float(seconds)
        s.last_s = float(seconds)

    def ema(self, key: str) -> float | None:
        s = self._stats.get(key)
        return s.ema_s if s is not None else None

    def count(self, key: str) -> int:
        s = self._stats.get(key)
        return s.count if s is not None else 0

    def hottest(self, n: int = 1) -> list[tuple[str, float]]:
        """Keys ranked by accumulated wall time (total time, not per-step
        time, is what adaptation can win back)."""
        ranked = sorted(self._stats.items(), key=lambda kv: -kv[1].total_s)
        return [(k, s.total_s) for k, s in ranked[: max(0, n)]]

    def reset(self, key: str) -> None:
        """Drop a key's stats."""
        self._stats.pop(key, None)

    def snapshot(self) -> dict[str, dict]:
        return {k: {"ema_s": s.ema_s, "count": s.count, "total_s": s.total_s,
                    "last_s": s.last_s}
                for k, s in self._stats.items()}


# ---------------------------------------------------------------------------
# a deployment-shaped tunable program (the engine's logit post-processing;
# addressable from spawn workers as
# import:repro_torch.autotune:logit_pipeline_program)
# ---------------------------------------------------------------------------

def logit_pipeline_program(vocab: int = 512, slots: int = 4,
                           name: str = "logit_pipeline") -> Program:
    """A canonical per-decode-step logit post-processing nest.

    Six elementwise stages over vocab-major ``(V, N)`` logits (per-token
    bias/scale/floor/shift/gain/cap against per-vocab vectors — the shape of
    real serving logit processors: penalties, temperature-like scaling,
    clamping), with the reference's arrays, temps, loop order and names.
    The stages are ``Expr`` trees (the reference writes lambdas over
    ``jax.numpy``), so the nest kernel can generate their body; the
    fingerprint and embedding are the reference's.  Two properties make it
    the online-tuning demo nest:

    * **recipe-sensitive**: vocab-major layout puts the size-``V`` loop
      outermost, so the ``sequential`` recipe lowers to a Python loop over
      the whole vocabulary while ``vectorize`` runs the chain as a handful
      of tensor ops and ``pallas_nest`` as one K2 launch;
    * **bit-stable**: no multiply feeds an add anywhere in the chain (the
      stages alternate add / multiply / max / min), so no lowering can
      contract an FMA and every legal lowering produces bit-identical
      outputs — hot-swapping recipes never changes a served token.

    Engine convention: the logits enter through input ``X`` of shape
    ``(vocab, batch_slots)`` and the processed logits leave through output
    ``Y`` of the same shape; every other input array is a deployment
    operand (``ServingEngine`` zero-fills the ones not given).
    """
    v, n = int(vocab), int(slots)
    x, b = Read(0), Read(1)
    c1 = Computation("bias", acc("T1", "v", "n"), (acc("X", "v", "n"), acc("B", "v")), x + b)
    c2 = Computation("scale", acc("T2", "v", "n"), (acc("T1", "v", "n"), acc("S", "v")), x * b)
    c3 = Computation("floor", acc("T3", "v", "n"), (acc("T2", "v", "n"), acc("F", "v")),
                     emax(x, b))
    c4 = Computation("shift", acc("T4", "v", "n"), (acc("T3", "v", "n"), acc("C", "v")), x + b)
    c5 = Computation("gain", acc("T5", "v", "n"), (acc("T4", "v", "n"), acc("G", "v")), x * b)
    c6 = Computation("cap", acc("Y", "v", "n"), (acc("T5", "v", "n"), acc("K", "v")),
                     emin(x, b))
    body = (Loop("v", v, body=(Loop("n", n, body=(c1, c2, c3, c4, c5, c6)),)),)
    arrays = (
        Array("X", (v, n)), Array("B", (v,)), Array("S", (v,)),
        Array("F", (v,)), Array("C", (v,)), Array("G", (v,)),
        Array("K", (v,)),
        Array("T1", (v, n)), Array("T2", (v, n)), Array("T3", (v, n)),
        Array("T4", (v, n)), Array("T5", (v, n)), Array("Y", (v, n)),
    )
    return Program(name, arrays, body, temps=("T1", "T2", "T3", "T4", "T5"))


# ---------------------------------------------------------------------------
# swap policy + supervisor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SwapPolicy:
    """When an online candidate may replace the incumbent recipe.

    ``margin``: the candidate's measured time must beat the incumbent's by
    this fraction (``cand * (1 + margin) < incumbent``) — hot-swapping for
    measurement noise would thrash the step functions.  ``validate`` runs
    the candidate through ``fault.compile_with_degradation`` (compile AND
    run once per backend rung) against a staged copy of the database
    before anything touches the live one.  ``rollback_ratio`` /
    ``rollback_window``: after a swap, if the telemetry EMA over the next
    ``rollback_window`` observations exceeds ``rollback_ratio`` x the
    pre-swap EMA, the swap is rolled back and the nest quarantined.
    ``min_observations`` keeps cold programs from being searched on no
    evidence.
    """

    margin: float = 0.1
    validate: bool = True
    validate_backends: tuple[str, ...] | None = None
    rollback_ratio: float = 1.5
    rollback_window: int = 8
    min_observations: int = 4

    def accepts(self, candidate_us: float, incumbent_us: float) -> bool:
        if not math.isfinite(candidate_us):
            return False
        if not math.isfinite(incumbent_us):
            return True  # incumbent unmeasurable: any validated candidate wins
        return candidate_us * (1.0 + self.margin) < incumbent_us

    def chain_for(self, backend: str) -> tuple[str, ...]:
        """Validation backend rungs: the deployment backend, degrading to
        ``torch`` (the rung order ``compile_with_degradation`` walks)."""
        if self.validate_backends is not None:
            return self.validate_backends
        return (backend,) if backend == "torch" else (backend, "torch")


@dataclass
class SwapRecord:
    """One committed hot-swap (kept on ``SearchSupervisor.swaps``)."""

    program: str
    fingerprint: str
    old_recipe: Recipe | None
    new_recipe: Recipe
    candidate_us: float
    incumbent_us: float
    generation: int
    degraded_to: str | None = None
    rolled_back: bool = False


@dataclass
class _RegisteredProgram:
    key: str              # program fingerprint == telemetry key
    program: Program
    name: str
    tasks: list[dict] = field(default_factory=list)


class SearchSupervisor:
    """Online adaptive tuning: telemetry -> search -> validate -> swap ->
    fold back.

    Owns the deployment's live :class:`TuningDatabase` and a
    :class:`NestTelemetry`; an engine attaches by passing the supervisor as
    ``tuner=`` (``ServingEngine`` registers its logit pipeline, observes
    step timings into ``tuner.telemetry``, and calls ``maybe_launch()`` /
    ``poll()`` every ``check_every`` steps).  Searches measure on
    ``device`` (the card unless ``device='cpu'``) under ``backend``.

    ``mode``: ``'thread'`` (default) runs searches on a daemon thread so
    serving never blocks on them; ``'sync'`` runs them inline at the poll
    point (deterministic — tests, benchmarks); ``'spawn'`` fans them across
    the supervised process pool (requires ``builder`` coordinates at
    ``register`` time, since IR lambdas do not pickle; on a CUDA device
    ``jobs > 1`` is refused, as the tune CLI refuses it: workers timing on
    one card at once corrupt each other's fitness).  All three run the
    same :func:`run_supervised` machinery, so errors retry then
    quarantine instead of surfacing.

    In ``'thread'`` mode the daemon thread shares the card with serving:
    it launches on a CUDA stream of its own (torch's current stream is per
    thread), so its kernels do not queue behind or ahead of the serving
    stream's and the two run side by side; its CUDA-event timings and the
    device-wide synchronize in ``util.time_fn`` still see serving's
    kernels on the card, so its measurements are noisy, while every tensor
    it touches is its own, so results stay right.  Validation and commits
    run on the serving thread, at its poll points.
    """

    def __init__(
        self,
        db: TuningDatabase,
        backend: str = "cuda",
        policy: SwapPolicy | None = None,
        telemetry: NestTelemetry | None = None,
        mode: str = "thread",
        jobs: int = 2,
        iterations: int = 2,
        population: int = 4,
        repeats: int = 3,
        deadline_s: float | None = 30.0,
        check_every: int = 16,
        task_timeout_s: float | None = None,
        max_task_retries: int = 1,
        fault_plan: FaultPlan | None = None,
        verbose: bool = False,
        device: str | torch.device = "cuda",
    ):
        if mode not in ("sync", "thread", "spawn"):
            raise ValueError(f"mode must be sync|thread|spawn, got {mode!r}")
        if mode == "spawn" and jobs > 1 and torch.device(device).type == "cuda":
            raise ValueError(f"jobs={jobs} on {device}: workers would time on one "
                             f"card at once; search on the card with jobs=1")
        self.db = db
        self.backend = backend
        self.policy = policy or SwapPolicy()
        self.telemetry = telemetry or NestTelemetry()
        self.mode = mode
        self.jobs = jobs
        self.iterations = iterations
        self.population = population
        self.repeats = repeats
        self.deadline_s = deadline_s
        self.check_every = max(1, int(check_every))
        self.task_timeout_s = task_timeout_s
        self.max_task_retries = max_task_retries
        self.fault_plan = fault_plan
        self.verbose = verbose
        self.swaps: list[SwapRecord] = []
        self.rejected: list[dict] = []
        self.quarantined: dict[str, str] = {}
        self.degradations: list[tuple[str, str, str]] = []
        self._scout = Daisy(backend=backend, device=device)
        self.device = self._scout.device
        self._registered: dict[str, _RegisteredProgram] = {}
        self._results: queue.Queue = queue.Queue()
        self._quarantines: deque[dict[str, str]] = deque()
        self._thread: threading.Thread | None = None
        self._inflight: set[str] = set()
        self._searched: set[str] = set()
        self._watch: dict[str, dict] = {}

    # -- registration ------------------------------------------------------
    def register(self, program: Program, builder: dict | None = None) -> str:
        """Make a deployment program tunable; returns its telemetry key
        (the program fingerprint — what the attached engine observes under).

        ``builder`` gives registry coordinates for spawn workers, e.g.
        ``{"source": "import", "name":
        "repro_torch.autotune:logit_pipeline_program", "builder_kwargs":
        {"vocab": 512, "slots": 4}}``; without it the program object itself
        rides in the task (in-process modes only).
        """
        key = program_fingerprint(program)
        if key in self._registered:
            return key
        if self.mode == "spawn" and builder is None:
            raise ValueError(
                "spawn mode needs builder coordinates (IR lambdas do not "
                "pickle): register(program, builder={'source': ..., 'name': ...})")
        name = getattr(program, "name", "program")
        p = self._scout._normalized(program)
        tasks: list[dict] = []
        for i, nest in enumerate(p.body):
            fp = fingerprint(nest)
            inc = self.db.lookup_exact(fp)
            t: dict = {
                "name": name, "nest_index": i, "backend": self.backend,
                "device": str(self.device),
                "fingerprint": fp, "iterations": self.iterations,
                "population": self.population, "repeats": self.repeats,
                "deadline_s": self.deadline_s, "program_key": key,
                "incumbent": inc.to_json() if inc is not None else None,
            }
            if builder is not None:
                t.update(builder)
            if self.mode != "spawn":
                t["program"] = program
            tasks.append(t)
        self._registered[key] = _RegisteredProgram(key, program, name, tasks)
        return key

    # -- search lifecycle --------------------------------------------------
    def maybe_launch(self) -> int:
        """Launch searches for the hottest registered program with unsearched
        nests (at most one search round in flight); returns tasks launched."""
        if self._thread is not None and self._thread.is_alive():
            return 0
        self._thread = None
        for key, _heat in self.telemetry.hottest(max(1, len(self._registered))):
            reg = self._registered.get(key)
            if reg is None:
                continue
            if self.telemetry.count(key) < self.policy.min_observations:
                continue
            tasks = [t for t in reg.tasks
                     if t["fingerprint"] not in self._searched
                     and t["fingerprint"] not in self._inflight
                     and t["fingerprint"] not in self.quarantined]
            if tasks:
                return self._launch(tasks)
        return 0

    def _launch(self, tasks: list[dict]) -> int:
        for t in tasks:
            self._inflight.add(t["fingerprint"])
        # refresh incumbents at launch (a previous swap may have changed them)
        staged = []
        for t in tasks:
            inc = self.db.lookup_exact(t["fingerprint"])
            staged.append(dict(t, incumbent=inc.to_json() if inc else None))

        def work() -> None:
            try:
                _, quarantined = run_supervised(
                    staged, jobs=(self.jobs if self.mode == "spawn" else 1),
                    verbose=self.verbose,
                    on_result=lambda _t, r: self._results.put(r),
                    task_timeout_s=self.task_timeout_s,
                    max_task_retries=self.max_task_retries,
                    fault_plan=self.fault_plan, worker=online_search_task)
            except Exception as e:  # noqa: BLE001 — supervisor must survive
                quarantined = {t["fingerprint"]: f"search round died: {e}"
                               for t in staged}
            if quarantined:
                self._quarantines.append(quarantined)

        if self.mode == "sync":
            work()
        else:
            self._thread = threading.Thread(
                target=self._on_own_stream, args=(work,), daemon=True,
                name="repro-torch-autotune")
            self._thread.start()
        return len(staged)

    def _on_own_stream(self, work) -> None:
        """Run ``work`` (the search thread's body) on a CUDA stream of its
        own when the searches measure on the card."""
        if self.device.type != "cuda":
            work()
            return
        with torch.cuda.device(self.device), torch.cuda.stream(torch.cuda.Stream(self.device)):
            work()

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def poll(self, engine=None) -> list[SwapRecord]:
        """Drain finished searches, apply the swap policy, check rollback
        watches; returns the swaps committed this call.  ``engine`` (when
        given) receives validation degradations on ``engine.degradations``.
        """
        while self._quarantines:
            for fp, reason in self._quarantines.popleft().items():
                self.quarantined[fp] = reason
                self._inflight.discard(fp)
        applied: list[SwapRecord] = []
        while True:
            try:
                r = self._results.get_nowait()
            except queue.Empty:
                break
            rec = self._consider(r, engine)
            if rec is not None:
                applied.append(rec)
        self._check_rollbacks()
        return applied

    # -- swap decision -----------------------------------------------------
    def _consider(self, r: dict, engine=None) -> SwapRecord | None:
        fp = r["fingerprint"]
        self._inflight.discard(fp)
        self._searched.add(fp)
        cand = Recipe.from_json(r["recipe"])
        inc = Recipe.from_json(r["incumbent"]) if r.get("incumbent") else None
        cand_us = float(r["measured_us"])
        inc_us = float(r.get("incumbent_us", float("inf")))
        pname = r.get("name", "?")

        def reject(reason: str) -> None:
            self.rejected.append({
                "fingerprint": fp, "program": pname, "reason": reason,
                "candidate_us": cand_us, "incumbent_us": inc_us,
                "candidate": cand.to_json()})

        if cand == inc:
            reject("no-win: search returned the incumbent")
            return None
        if not self.policy.accepts(cand_us, inc_us):
            reject(f"margin: {cand_us:.0f}us does not beat "
                   f"{inc_us:.0f}us by {self.policy.margin:.0%}")
            return None
        degraded_to = None
        reg = self._registered.get(r.get("program_key", ""))
        if self.policy.validate and reg is not None:
            ok, degraded_to, err = self._validate(reg.program, fp, cand, r)
            if not ok:
                reject(f"validation: {err}")
                return None
            if degraded_to is not None:
                sink = engine.degradations if engine is not None \
                    else self.degradations
                sink.append((pname, self.backend, degraded_to))
        prev = self._commit(fp, cand, cand_us, r)
        rec = SwapRecord(pname, fp, inc, cand, cand_us, inc_us,
                         generation=self.db.generation,
                         degraded_to=degraded_to)
        self.swaps.append(rec)
        self._arm_watch(fp, r.get("program_key", ""), prev, rec)
        return rec

    def _validate(self, program: Program, fp: str, cand: Recipe,
                  r: dict) -> tuple[bool, str | None, str | None]:
        """Compile + run once the program with the candidate staged in a
        scratch database — the live one is untouched until commit."""
        from .fault import compile_with_degradation

        emb = np.asarray(r.get("embedding", []), dtype=np.float64)
        val_db = TuningDatabase(radius=self.db.radius)
        replaced = False
        for e in self.db.entries:
            if e.fingerprint == fp:
                val_db.entries.append(Entry(fp, emb, cand, "online-candidate"))
                replaced = True
            else:
                val_db.entries.append(e)
        if not replaced:
            val_db.entries.append(Entry(fp, emb, cand, "online-candidate"))
        val_db._reindex()
        try:
            res = compile_with_degradation(
                program, backends=self.policy.chain_for(self.backend),
                db=val_db, fault_plan=self.fault_plan, device=self.device)
        except Exception as e:  # noqa: BLE001 — every rung failed
            return False, None, str(e)
        return True, (res.backend if res.degraded else None), None

    def _commit(self, fp: str, cand: Recipe, cand_us: float, r: dict):
        """Write the validated winner into the live database (generation
        bump = the hot swap: the engine's step-function cache keys carry the
        generation, so the next step resolves the new recipe).  Returns the
        previous entry contents for rollback, or None for a fresh entry."""
        prov = r.get("provenance", "online")
        if self.db.lookup_exact(fp) is None:
            emb = np.asarray(r.get("embedding", []), dtype=np.float64)
            self.db.add(fp, emb, cand, provenance=prov, measured_us=cand_us)
            return None
        # replace_entry, not add: the incumbent may carry a stale *smaller*
        # measurement from the machine it was tuned on — live-validated
        # measurements taken here outrank it unconditionally
        return self.db.replace_entry(fp, cand, measured_us=cand_us,
                                     provenance=prov)

    # -- rollback ----------------------------------------------------------
    def _arm_watch(self, fp: str, key: str, prev, rec: SwapRecord) -> None:
        pre = self.telemetry.ema(key)
        self.telemetry.reset(key)  # the watch compares post-swap steps only
        self._watch[fp] = {"key": key, "pre_ema_s": pre, "prev": prev,
                           "record": rec}

    def _check_rollbacks(self) -> None:
        for fp, w in list(self._watch.items()):
            if self.telemetry.count(w["key"]) < self.policy.rollback_window:
                continue
            post, pre = self.telemetry.ema(w["key"]), w["pre_ema_s"]
            del self._watch[fp]
            if pre is not None and post is not None \
                    and post > self.policy.rollback_ratio * pre:
                self._rollback(fp, w, post, pre)

    def _rollback(self, fp: str, w: dict, post: float, pre: float) -> None:
        """The candidate won its isolated measurement but regressed live:
        restore the incumbent verbatim (generation bump un-swaps the step
        functions) and quarantine the nest against re-searching."""
        prev = w["prev"]
        if prev is not None:
            self.db.replace_entry(fp, prev[0], measured_us=prev[1],
                                  provenance=prev[2])
        else:
            self.db.entries[:] = [e for e in self.db.entries
                                  if e.fingerprint != fp]
            self.db.reindex()
        w["record"].rolled_back = True
        self.quarantined[fp] = (
            f"rolled back: post-swap EMA {post * 1e6:.0f}us > "
            f"{self.policy.rollback_ratio:.2f}x pre-swap {pre * 1e6:.0f}us")
        if self.verbose:
            print(f"  ROLLBACK {fp[:50]}: {self.quarantined[fp]}", flush=True)

    # -- fleet fold-back ---------------------------------------------------
    def fold_back(self, path: str | Path) -> dict[str, int]:
        """Merge this deployment's database (online winners included) into
        the fleet database file at ``path`` — atomic checksummed
        ``merge()`` + ``save()``, so concurrent fold-backs from several
        deployments compose and a reader never sees a torn file.  Returns
        the merge report ``{'added': n, 'improved': n, 'kept': n}``.
        """
        path = Path(path)
        disk = TuningDatabase.load(path) if path.exists() else TuningDatabase()
        report = disk.merge(self.db)
        n_swaps = sum(1 for s in self.swaps if not s.rolled_back)
        if n_swaps:
            disk.meta["online_swaps"] = int(
                disk.meta.get("online_swaps", 0)) + n_swaps
        path.parent.mkdir(parents=True, exist_ok=True)
        disk.save(path)
        return report
