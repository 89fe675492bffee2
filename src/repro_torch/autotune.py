"""Offline autotune core: the search/measurement machine behind the tune CLI.

Port of the offline half of ``repro/autotune.py``:

  * :func:`program_specs` / :func:`build_program` — registry coordinates of
    tunable programs, rebuildable inside spawn workers (IR computations
    hold lambdas, which do not pickle);
  * :func:`tune_nest_task` — the per-nest epoch-1 search worker, which
    times candidates on the task's ``device``;
  * :func:`run_supervised` — the supervised pool: per-task progress
    timeouts, bounded retries with solo-isolation crash forensics, and
    fingerprint-keyed quarantine, over either an in-process queue
    (``jobs <= 1``) or a spawn ``ProcessPoolExecutor``.

On the card, workers that time at once share it and corrupt each other's
fitness: tune on one card with ``jobs=1``.  A sticky CUDA error (an illegal
address) leaves the process unable to launch anything else, so it ends an
in-process run and kills a pool worker (which the pool then treats as a
crash) instead of being retried in the same process.

Of the online half, only ``NestStat`` and ``NestTelemetry`` are ported: a
deployment's (disabled) telemetry sink.  ``SearchSupervisor`` and
``SwapPolicy`` are not ported yet.
"""
from __future__ import annotations

import hashlib
import multiprocessing
import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch

from .core import Daisy, Program, fingerprint
from .core import search
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


def build_program(source: str, name: str, size: str = "mini") -> Program:
    """Rebuild a program from its registry coordinates (IR computations hold
    lambdas, which do not pickle — workers reconstruct instead of receiving)."""
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
        prog = build_program(task["source"], task["name"], task["size"])
        d = Daisy(backend=task["backend"], device=task.get("device", "cuda"))
        p = d._normalized(prog)
        nest = p.body[task["nest_index"]]
        # fail fast, before the search burns its compile+measure budget
        if fingerprint(nest) != task["fingerprint"]:
            raise RuntimeError(
                f"normalization diverged between parent and worker for "
                f"{task['name']} nest {task['nest_index']}"
            )
        before = search.COUNTS["measurements"]
        fp, emb, recipe, t, prov = d.seed_nest(
            p, nest, search=task["search"], search_iterations=task["iterations"],
            population=task["population"], repeats=task["repeats"],
        )
        measured = search.COUNTS["measurements"] - before
    except Exception:
        if multiprocessing.parent_process() is not None and _device_lost(task):
            os._exit(4)  # a pool worker that can no longer launch: die as a crash
        raise
    return {"fingerprint": fp, "embedding": np.asarray(emb).tolist(),
            "recipe": recipe.to_json(), "measured_us": t, "provenance": prov,
            "measurements": measured}


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
) -> tuple[list[dict], dict[str, str]]:
    """Run per-nest searches under supervision.

    Returns ``(results, quarantined)`` where ``quarantined`` maps nest
    fingerprints that exhausted their retries to a reason string.
    ``on_result(task, result)`` fires as each nest lands (checkpoint hook).
    Each task runs :func:`tune_nest_task`.
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
                r = tune_nest_task(t)
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
            futs = {ex.submit(tune_nest_task, t): t for t in round_tasks}
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
