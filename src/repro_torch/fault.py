"""Bounded restarts and deterministic fault injection for the tuning pool.

Port of the part of ``repro/fault.py`` that the supervised tuning pool
(``repro_torch.autotune.run_supervised``) needs: ``RestartPolicy``,
``FaultInjected``, ``Fault`` and ``FaultPlan``, copied with import roots
changed.  A seeded :class:`FaultPlan` names *where* (site), *what* (kind)
and *when* (key / firing count) a fault strikes, so tests replay the exact
same failure schedule every run::

    from repro_torch.fault import Fault, FaultPlan

    plan = FaultPlan([Fault("tune.worker", "crash", key=fingerprint, times=2)])
    tune(..., jobs=2, fault_plan=plan)   # that nest's worker dies twice
    assert plan.fired                    # the log of (site, key, kind) strikes
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np


@dataclass
class RestartPolicy:
    """Bounded retry-with-backoff loop (the tune pool's per-task retries)."""

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
