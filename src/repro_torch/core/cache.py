"""Content-addressed compilation cache.

Port of ``repro/core/cache.py``: a copy; its code differs only in import roots.

The paper's premise is that a priori normalization collapses many loop-nest
variants onto one canonical form, so a small recipe database covers them.
This module exploits the same property at the *compilation* layer: a stable
whole-program fingerprint (``repro.core.ir.program_fingerprint``) addresses
the memoized result of the ``normalize -> plan -> compile`` chain, so a
repeated or structurally-identical program returns the cached compiled
callable instead of re-running fission, stride minimization and recipe
resolution.

Three pieces:

* ``CacheStats``      — hit/miss/eviction counters (surfaced on ``Daisy``).
* ``CompilationCache``— a bounded LRU from content-derived keys to compiled
                        artifacts; shared by the scheduler, the serving
                        engine and the trainer.
* ``fingerprint_obj`` — a stable content fingerprint for configuration
                        objects (nested dataclasses / primitives), used to
                        key jitted model functions so re-created engines or
                        trainers with equal configs reuse one jitted fn.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Hashable

import numpy as np


@dataclass
class CacheStats:
    """Hit/miss/eviction counters for one ``CompilationCache``."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        """Total lookups (hits + misses)."""
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from the cache (0.0 when unused)."""
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict[str, float]:
        """The counters as a plain dict (telemetry/JSON artifacts)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hit_rate, 4),
        }

    def __repr__(self) -> str:
        return (
            f"CacheStats(hits={self.hits}, misses={self.misses}, "
            f"evictions={self.evictions}, hit_rate={self.hit_rate:.2%})"
        )


_MISSING = object()


class CompilationCache:
    """Bounded LRU cache from content-derived keys to compiled artifacts.

    Keys must be hashable tuples built from content fingerprints (never
    object identity), so two structurally-identical inputs share a slot.
    Values are arbitrary compiled artifacts: jitted callables, ``ProgramPlan``
    objects, normalized programs.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:  # does not touch stats/LRU
        return key in self._entries

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Look ``key`` up, counting the hit/miss and refreshing LRU order."""
        val = self._entries.get(key, _MISSING)
        if val is _MISSING:
            self.stats.misses += 1
            return default
        self.stats.hits += 1
        self._entries.move_to_end(key)
        return val

    def put(self, key: Hashable, value: Any) -> None:
        """Insert (or refresh) ``key``, evicting LRU entries past capacity."""
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, building + caching on miss."""
        val = self.get(key, _MISSING)
        if val is _MISSING:
            val = build()
            self.put(key, val)
        return val

    def invalidate(self, key: Hashable | None = None) -> None:
        """Drop one entry (or everything, if ``key`` is None). Stats survive."""
        if key is None:
            self._entries.clear()
        else:
            self._entries.pop(key, None)


def _canon(obj: Any) -> str:
    """Canonical text form of a configuration value, for fingerprinting."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        inner = ",".join(
            f"{f.name}={_canon(getattr(obj, f.name))}"
            for f in dataclasses.fields(obj)
        )
        return f"{type(obj).__name__}({inner})"
    if isinstance(obj, dict):
        inner = ",".join(f"{_canon(k)}:{_canon(v)}" for k, v in sorted(obj.items(), key=repr))
        return f"{{{inner}}}"
    if isinstance(obj, (list, tuple)):
        return f"[{','.join(_canon(x) for x in obj)}]"
    if isinstance(obj, np.ndarray):
        return f"nd{obj.shape}{obj.dtype}:{hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest()[:16]}"
    if isinstance(obj, float):
        return f"{obj:.17g}"
    if callable(obj):
        return f"fn:{getattr(obj, '__qualname__', repr(obj))}"
    return repr(obj)


def fingerprint_obj(*objs: Any) -> str:
    """Stable content fingerprint of configuration objects.

    Recurses through dataclasses, dicts, sequences and numpy arrays; two
    equal-content configs fingerprint identically across processes (modulo
    opaque callables, which hash by qualified name).
    """
    return hashlib.sha256("|".join(_canon(o) for o in objs).encode()).hexdigest()


# A process-wide cache for jitted model-level functions (serving decode
# steps, train steps).  Keyed by config fingerprints so re-created engines
# and trainers reuse one jitted function — and with it jax's trace cache.
jit_cache = CompilationCache(capacity=64)
