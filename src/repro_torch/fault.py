"""Heartbeats, stragglers, bounded restarts, deterministic fault injection
and the backend degradation chain.

Port of ``repro/fault.py``: ``Heartbeat``, ``StragglerMonitor``,
``RestartPolicy``, ``FaultInjected``, ``Fault`` and ``FaultPlan`` (copied
with import roots changed), ``truncate_file``,
``DegradedCompile`` and ``compile_with_degradation`` (``:225-297``), whose
ladder is ``cuda -> torch`` and whose every rung runs once on the card
before it is accepted.  A seeded :class:`FaultPlan` names *where* (site),
*what* (kind) and *when* (key / firing count) a fault strikes, so tests
replay the exact same failure schedule every run::

    from repro_torch.fault import Fault, FaultPlan

    plan = FaultPlan([Fault("tune.worker", "crash", key=fingerprint, times=2)])
    tune(..., jobs=2, fault_plan=plan)   # that nest's worker dies twice
    assert plan.fired                    # the log of (site, key, kind) strikes

``Heartbeat`` and ``StragglerMonitor`` (``:68-128``) are the trainer's
(``train.Trainer``); ``compile_with_degradation`` passes ``mesh`` and
``shard_axis`` to each rung's ``Daisy`` (the sharded path,
``repro_torch.core.partition``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable

import numpy as np


class Heartbeat:
    """Background thread stamping a file; a supervisor (or test) detects a
    dead/stuck process by file age.  Stamps are written atomically (tmp +
    ``os.replace``) so a reader can never parse a half-written file and
    mistake a live process for a dead one."""

    def __init__(self, path: str | Path, interval: float = 1.0):
        self.path = Path(path)
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stamp(self) -> None:
        tmp = self.path.with_name(f".{self.path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps({"t": time.time(), "pid": os.getpid()}))
        os.replace(tmp, self.path)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._stamp()
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    @staticmethod
    def age(path: str | Path) -> float | None:
        p = Path(path)
        if not p.exists():
            return None
        try:
            return time.time() - json.loads(p.read_text())["t"]
        except Exception:
            return None


@dataclass
class StragglerMonitor:
    """EMA step-time tracker; flags steps slower than ``threshold`` x EMA."""

    threshold: float = 3.0
    alpha: float = 0.1
    ema: float | None = None
    flagged: list[tuple[int, float]] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.flagged.append((step, dt))
        # don't fold outliers into the EMA
        if not is_straggler:
            self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


@dataclass
class RestartPolicy:
    """Bounded retry-with-backoff loop: ``Trainer.run_resilient``
    (restore-from-checkpoint) and the tune pool's per-task retries."""

    max_restarts: int = 3
    backoff_s: float = 0.0
    restarts: int = 0

    def should_restart(self, exc: Exception) -> bool:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            return False
        if self.backoff_s:
            time.sleep(self.backoff_s * self.restarts)
        return True


class FaultInjected(RuntimeError):
    """The error a ``kind='error'`` fault raises at its injection site."""


@dataclass
class Fault:
    """One scheduled fault.

    ``site`` names the injection point (``tune.worker``); ``kind`` what
    happens there (``error`` raises :class:`FaultInjected`, ``crash``
    hard-kills a pool worker, ``hang`` stalls it); ``key`` restricts the
    fault to one nest fingerprint (``None`` matches any); ``times`` is how
    many firings before the fault burns out (< 0 = unlimited).
    """

    site: str
    kind: str = "error"
    key: Any = None
    times: int = 1


class FaultPlan:
    """A seeded, deterministic schedule of faults.

    Explicit :class:`Fault` entries fire when their site/key matches (each
    at most ``times`` times); on top of that, a ``rate`` in (0, 1] arms
    every listed ``sites`` entry with seeded random ``error`` faults.  Every
    firing is recorded in ``fired`` so tests can assert the schedule was
    exercised.
    """

    def __init__(self, faults: tuple[Fault, ...] | list[Fault] = (),
                 seed: int = 0, rate: float = 0.0,
                 sites: tuple[str, ...] = ()):
        self.faults = [replace(f) for f in faults]  # own the mutable counters
        self.rate = float(rate)
        self.sites = tuple(sites)
        self.rng = np.random.default_rng(seed)
        self.fired: list[tuple[str, Any, str]] = []

    def fire(self, site: str, key: Any = None) -> Fault | None:
        """The fault striking ``site`` for ``key`` right now, or None.
        A returned fault's firing is consumed and recorded."""
        for f in self.faults:
            if f.site != site or f.times == 0:
                continue
            if f.key is not None and f.key != key:
                continue
            if f.times > 0:
                f.times -= 1
            self.fired.append((site, key, f.kind))
            return f
        if self.rate > 0.0 and site in self.sites and self.rng.random() < self.rate:
            self.fired.append((site, key, "error"))
            return Fault(site, "error", key=key, times=0)
        return None

    def maybe_raise(self, site: str, key: Any = None) -> Fault | None:
        """``fire``, raising :class:`FaultInjected` for ``error`` faults;
        non-error faults are returned for the site to interpret."""
        f = self.fire(site, key)
        if f is not None and f.kind == "error":
            raise FaultInjected(f"injected fault at {site} (key={key!r})")
        return f

    def count(self, site: str | None = None) -> int:
        return sum(1 for s, _, _ in self.fired if site is None or s == site)


def truncate_file(path: str | Path, keep_fraction: float = 0.5) -> None:
    """Clip a file to a prefix — the ``truncate`` fault: what a crash or a
    full disk leaves behind when a writer was not atomic."""
    p = Path(path)
    data = p.read_bytes()
    p.write_bytes(data[: max(0, int(len(data) * keep_fraction))])


# ---------------------------------------------------------------------------
# backend degradation chain
# ---------------------------------------------------------------------------


@dataclass
class DegradedCompile:
    """Result of :func:`compile_with_degradation`: the compiled fn, its
    plan, which backend finally succeeded, and the per-backend errors the
    chain absorbed on the way (empty = first choice worked)."""

    fn: Callable
    plan: Any
    backend: str
    errors: list[tuple[str, Exception]] = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.errors)


def compile_with_degradation(
    program,
    backends: tuple[str, ...] = ("cuda", "torch"),
    db=None,
    mesh=None,
    shard_axis: str = "data",
    fault_plan: FaultPlan | None = None,
    validate: bool = True,
    device="cuda",
) -> DegradedCompile:
    """Compile a canonical program, degrading across backends on failure.

    Tries each backend in order through a fresh ``Daisy`` on ``device`` —
    under ``'torch'`` the kernel recipes map onto their torch equivalents
    (``Daisy._backend_recipe``), so a nest kernel that fails to build still
    serves through the torch lowering.  Triton compiles a kernel at its
    first launch, so a compile that "succeeds" can still fail at its first
    call: each rung is *validated* by running once on random inputs and
    synchronizing the device (never promote a function that has not run).
    Raises the *first* backend's error (with the rest chained) only when
    every rung fails.  Injection site ``daisy.compile`` (key = backend)
    simulates compile failures per rung.  The ladder is taken only when a
    whole compile or its validation run fails, never around a live launch.
    Under ``mesh`` every rung is a sharded ``Daisy`` on the mesh's device,
    and every rank of the mesh must make the same call.
    """
    import torch

    from .core.scheduler import Daisy, random_inputs

    if not backends:
        raise ValueError("compile_with_degradation needs at least one backend")
    errors: list[tuple[str, Exception]] = []
    for b in backends:
        try:
            if fault_plan is not None:
                fault_plan.maybe_raise("daisy.compile", key=b)
            d = Daisy(db=db, backend=b, device=None if mesh is not None else device,
                      mesh=mesh, shard_axis=shard_axis)
            fn, plan = d.compile(program)
            if validate:
                fn(random_inputs(program))
                if d.device.type == "cuda":
                    torch.cuda.synchronize(d.device)  # the run's errors surface here
            return DegradedCompile(fn, plan, b, errors)
        except Exception as e:  # noqa: BLE001 — every rung failure degrades
            errors.append((b, e))
    raise RuntimeError(
        f"all backends failed compiling {getattr(program, 'name', program)!r}: "
        + "; ".join(f"{b}: {e}" for b, e in errors)
    ) from errors[0][1]
