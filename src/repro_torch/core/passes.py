"""Compiler pass pipeline — the "then-optimize" half of normalize-then-optimize.

Port of ``repro/core/passes.py``: a copy; its code differs only in import roots.

The paper's thesis (§2, §4) is that mapping loop nests onto one canonical
form lets a small set of recipes cover many programs.  The passes that build
that canonical form — and every optimization applied after it — are
program -> program transformations; this module gives them an explicit
spine so they can be inserted, inspected, timed, and cached individually
instead of living inside a hardcoded function chain:

* ``Pass``         — the protocol: a named ``run(program) -> Program``.
* ``FunctionPass`` — wraps a plain ``Program -> Program`` function.
* ``FixpointPass`` — re-applies a pass until the program body stops changing
                     (maximal fission only ever splits further).
* ``PassContext``  — per-pass wall time, nest/computation counts, custom
                     stats, optional IR snapshots; ``report()`` renders the
                     table the CLI (``repro.tools.explain``) and the dry-run
                     CLI surface.
* ``PassPipeline`` — an ordered, editable pass list; ``run`` threads the
                     program through, optionally memoizing each stage in a
                     ``CompilationCache`` keyed by the *input* program's
                     content fingerprint (so two programs sharing a prefix
                     of identical intermediate forms share the work).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Protocol, Sequence, runtime_checkable

from .ir import Program, program_computations, program_fingerprint


@runtime_checkable
class Pass(Protocol):
    """One program -> program transformation with a stable name."""

    name: str

    def run(self, program: Program, ctx: "PassContext | None" = None) -> Program:
        """Transform ``program``, optionally attaching stats to ``ctx``."""
        ...  # pragma: no cover - protocol


@dataclass
class FunctionPass:
    """Adapts a plain ``Program -> Program`` function to the Pass protocol."""

    name: str
    fn: Callable[[Program], Program]

    def run(self, program: Program, ctx: "PassContext | None" = None) -> Program:
        """Apply the wrapped function once (``ctx`` is unused)."""
        return self.fn(program)


@dataclass
class FixpointPass:
    """Re-applies ``fn`` until the program body is stable (or max_iter)."""

    name: str
    fn: Callable[[Program], Program]
    max_iter: int = 64

    def run(self, program: Program, ctx: "PassContext | None" = None) -> Program:
        """Iterate to a fixed point, recording the iteration count."""
        cur = program
        for it in range(self.max_iter):
            nxt = self.fn(cur)
            if nxt.body == cur.body:
                if ctx is not None:
                    ctx.add_stat(self.name, "iterations", it + 1)
                return nxt
            cur = nxt
        if ctx is not None:  # pragma: no cover - defensive
            ctx.add_stat(self.name, "iterations", self.max_iter)
        return cur


@dataclass
class PassRecord:
    """What one pass did to one program."""

    name: str
    seconds: float
    nests_before: int
    nests_after: int
    comps_before: int
    comps_after: int
    stats: dict[str, Any] = field(default_factory=dict)
    cached: bool = False
    before: Program | None = None  # IR snapshots (ctx.snapshots=True)
    after: Program | None = None


class PassContext:
    """Carries observability across one pipeline run.

    ``records`` accumulate in pass order; passes may attach custom stats
    (e.g. the fusion pass records how many nests it merged) via
    ``add_stat`` while they run.  With ``snapshots=True`` every record also
    keeps the full before/after IR — handy in tests and the explain CLI,
    wasteful in production, hence opt-in.
    """

    def __init__(self, snapshots: bool = False):
        self.snapshots = snapshots
        self.records: list[PassRecord] = []
        self._pending: dict[str, dict[str, Any]] = {}

    # -- recording ----------------------------------------------------------
    def add_stat(self, pass_name: str, key: str, value: Any) -> None:
        """Called by a pass *while it runs*; folded into its record."""
        self._pending.setdefault(pass_name, {})[key] = value

    def record(
        self,
        name: str,
        seconds: float,
        before: Program,
        after: Program,
        cached: bool = False,
    ) -> PassRecord:
        """Finalize one pass run into a ``PassRecord`` (folds pending stats)."""
        rec = PassRecord(
            name=name,
            seconds=seconds,
            nests_before=len(before.body),
            nests_after=len(after.body),
            comps_before=len(program_computations(before)),
            comps_after=len(program_computations(after)),
            stats=self._pending.pop(name, {}),
            cached=cached,
            before=before if self.snapshots else None,
            after=after if self.snapshots else None,
        )
        self.records.append(rec)
        return rec

    # -- introspection ------------------------------------------------------
    def __getitem__(self, pass_name: str) -> PassRecord:
        for rec in reversed(self.records):
            if rec.name == pass_name:
                return rec
        raise KeyError(pass_name)

    @property
    def total_seconds(self) -> float:
        """Wall time summed over all recorded passes."""
        return sum(r.seconds for r in self.records)

    def stat(self, pass_name: str, key: str, default: Any = None) -> Any:
        """A single stat from a pass's latest record (``default`` if absent)."""
        try:
            return self[pass_name].stats.get(key, default)
        except KeyError:
            return default

    def report(self) -> str:
        """Aligned per-pass table (rendered by the CLI and the dry-run tool)."""
        header = ("pass", "time", "nests", "comps", "stats")
        rows = [header]
        for r in self.records:
            stats = dict(r.stats)
            if r.cached:
                stats["cached"] = True
            rows.append((
                r.name,
                f"{r.seconds * 1e3:.2f}ms",
                f"{r.nests_before}->{r.nests_after}",
                f"{r.comps_before}->{r.comps_after}",
                " ".join(f"{k}={v}" for k, v in stats.items()),
            ))
        rows.append(("total", f"{self.total_seconds * 1e3:.2f}ms", "", "", ""))
        widths = [max(len(row[c]) for row in rows) for c in range(len(header))]
        lines = []
        for i, row in enumerate(rows):
            lines.append("  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip())
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return "\n".join(lines)


class PassPipeline:
    """An ordered sequence of passes over the loop-nest IR.

    ``run`` threads the program through every pass.  When a
    ``CompilationCache`` is supplied, each stage's output is memoized under
    ``('pass', stage name, fingerprint(stage input))`` — content-addressed,
    so structurally-identical intermediate programs (the paper's A/B
    variants converge after a few passes) share all downstream stage work.
    """

    def __init__(self, passes: Sequence[Pass], name: str = "pipeline"):
        self.name = name
        self._passes: list[Pass] = list(passes)
        seen: set[str] = set()
        for p in self._passes:
            if p.name in seen:
                raise ValueError(f"duplicate pass name: {p.name!r}")
            seen.add(p.name)

    # -- list-like access ---------------------------------------------------
    def __iter__(self) -> Iterator[Pass]:
        return iter(self._passes)

    def __len__(self) -> int:
        return len(self._passes)

    @property
    def names(self) -> tuple[str, ...]:
        """The pass names in execution order."""
        return tuple(p.name for p in self._passes)

    def __getitem__(self, name: str) -> Pass:
        for p in self._passes:
            if p.name == name:
                return p
        raise KeyError(name)

    # -- editing (returns new pipelines; instances stay immutable-ish) ------
    def with_pass(
        self, p: Pass, *, before: str | None = None, after: str | None = None
    ) -> "PassPipeline":
        """A new pipeline with ``p`` inserted (appended when no anchor)."""
        if before is not None and after is not None:
            raise ValueError("give at most one of before/after")
        passes = list(self._passes)
        if before is None and after is None:
            passes.append(p)
        else:
            anchor = before if before is not None else after
            idx = self.names.index(anchor)  # raises ValueError if unknown
            passes.insert(idx if before is not None else idx + 1, p)
        return PassPipeline(passes, name=self.name)

    def without_pass(self, name: str) -> "PassPipeline":
        """A new pipeline with the named pass removed (KeyError if unknown)."""
        if name not in self.names:
            raise KeyError(name)
        return PassPipeline(
            [p for p in self._passes if p.name != name], name=self.name
        )

    # -- execution ----------------------------------------------------------
    def run(
        self,
        program: Program,
        ctx: PassContext | None = None,
        cache: "Any | None" = None,  # CompilationCache-compatible
    ) -> Program:
        """Run every pass in order, recording into ``ctx`` and memoizing
        per-pass results in ``cache`` when one is given."""
        cur = program
        for p in self._passes:
            t0 = time.perf_counter()
            cached = False
            if cache is not None:
                key = ("pass", p.name, program_fingerprint(cur))
                hit = cache.get(key)
                if hit is not None:
                    nxt, cached = hit, True
                else:
                    nxt = p.run(cur, ctx)
                    cache.put(key, nxt)
            else:
                nxt = p.run(cur, ctx)
            if ctx is not None:
                ctx.record(p.name, time.perf_counter() - t0, cur, nxt, cached=cached)
            cur = nxt
        return cur

    def run_with_report(self, program: Program, snapshots: bool = False) -> tuple[Program, PassContext]:
        """Run with a fresh ``PassContext``; returns (program, context)."""
        ctx = PassContext(snapshots=snapshots)
        out = self.run(program, ctx=ctx)
        return out, ctx

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PassPipeline({self.name}: {' -> '.join(self.names)})"
