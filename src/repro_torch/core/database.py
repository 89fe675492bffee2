"""Transfer-tuning database (paper §4): canonical nest -> recipe.

Port of ``repro/core/database.py``: a copy of the lookup, the v2 JSON
persistence, ``merge``, ``replace_entry`` and ``summary``, with import roots
changed.  Files written by either package load in the other (fingerprints
are byte-identical).  The shipped databases are ``data/pretuned_cuda.json``
(tuned on the card by ``repro_torch.tools.tune``, the default) and the
reference's ``data/pretuned_xla.json``.

Lookup order mirrors the paper exactly:
 1. exact fingerprint match ("if a B loop nest is reduced to an A loop nest")
 2. nearest neighbour by Euclidean distance on the performance embedding
    (within ``radius``); the recipe of the most similar nest transfers.
 3. miss -> the caller falls back to the default recipe.

Both lookups are indexed: exact matches go through a fingerprint
dict, and nearest-neighbour queries run one vectorized ``np.linalg.norm``
over a stacked embedding matrix instead of a Python loop per entry.  A
``generation`` counter bumps on every mutation so the compilation cache can
key plans by database state.

The database is JSON-persistable so seeded schedules ship with the
framework; the format is versioned (v2 adds the ``version`` field) and
``load`` accepts the unversioned v1 files written by the seed revision.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .embedding import distance
from .recipes import Recipe

SCHEMA_VERSION = 2


class DatabaseCorruption(RuntimeError):
    """A database file (and its ``.bak``, if any) failed to parse or failed
    its content checksum."""

# Directory holding the shipped pretuned databases (``repro_torch.tools.tune``
# output).  Overridable for deployments that stage their own tuning data.
PRETUNED_DIR_ENV = "REPRO_PRETUNED_DIR"


def pretuned_dir() -> Path:
    """Directory holding shipped pretuned databases (env-overridable)."""
    d = os.environ.get(PRETUNED_DIR_ENV)
    return Path(d) if d else Path(__file__).resolve().parents[3] / "data"


def default_pretuned_path(backend: str = "cuda") -> Path:
    """Path of the shipped pretuned database for ``backend``.

    Looks for ``pretuned_<backend>.json`` then the generic ``pretuned.json``
    under ``pretuned_dir()``; raises FileNotFoundError (with the tune-CLI
    incantation) when neither exists.
    """
    root = pretuned_dir()
    cands = [root / f"pretuned_{backend}.json", root / "pretuned.json"]
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"no pretuned database for backend {backend!r} under {root} "
        f"(looked for {', '.join(c.name for c in cands)}); generate one with "
        f"`python -m repro_torch.tools.tune --suite all --backend {backend} "
        f"--out {cands[0]}`"
    )


def try_load_pretuned(backend: str = "cuda") -> "TuningDatabase | None":
    """The shipped pretuned database, or None when none is installed."""
    try:
        return TuningDatabase.load(default_pretuned_path(backend))
    except FileNotFoundError:
        return None


@dataclass
class Entry:
    """One tuned nest: canonical fingerprint, embedding, winning recipe."""

    fingerprint: str
    embedding: np.ndarray
    recipe: Recipe
    provenance: str = ""
    measured_us: float | None = None


@dataclass
class TuningDatabase:
    """Fingerprint-addressed recipe store with nearest-embedding transfer.

    Exact fingerprint hits return the tuned recipe; misses fall back to the
    nearest structural embedding within ``radius``.  Persistence is atomic
    and checksummed (see the persistence section below).
    """

    entries: list[Entry] = field(default_factory=list)
    radius: float = 6.0
    # Free-form tuning provenance (suite/size/backend/timestamp, written by
    # ``repro.tools.tune``); persisted alongside the entries.
    meta: dict = field(default_factory=dict)

    _uid_counter = itertools.count()

    def __post_init__(self) -> None:
        # Process-unique, never-reused instance token: cache keys derived
        # from a database must use this (plus ``generation``), not ``id()``
        # — a freed database's address can be reused by a new instance,
        # which would let a module-global cache serve stale results.
        self.uid = next(TuningDatabase._uid_counter)
        self._gen = 0
        self._by_fp: dict[str, int] = {}
        self._matrix: np.ndarray | None = None
        self._reindex()

    # -- index maintenance ---------------------------------------------------
    def _reindex(self) -> None:
        self._by_fp = {}
        for i, e in enumerate(self.entries):
            self._by_fp.setdefault(e.fingerprint, i)
        self._matrix = None

    def _sync(self) -> None:
        # Mutations should go through add(); the length check catches the
        # legacy direct-append pattern.  In-place *replacement* of an entry
        # keeps the length and is not detected — call reindex() after one.
        if len(self.entries) != len(self._by_fp):
            self._reindex()
            self._gen += 1

    def reindex(self) -> None:
        """Rebuild the lookup index after mutating ``entries`` in place."""
        self._reindex()
        self._gen += 1

    @property
    def generation(self) -> int:
        """Bumps on every mutation — cache keys derived from this database
        must include it so plans resolved against older contents expire."""
        self._sync()
        return self._gen

    def add(self, fingerprint: str, embedding: np.ndarray, recipe: Recipe,
            provenance: str = "", measured_us: float | None = None) -> str:
        """Insert or upgrade an entry; returns what happened:
        ``'added'`` | ``'replaced'`` (better-measured recipe won) | ``'kept'``."""
        self._sync()
        i = self._by_fp.get(fingerprint)
        if i is not None:
            e = self.entries[i]
            # keep the better-measured recipe
            if measured_us is not None and (e.measured_us is None or measured_us < e.measured_us):
                e.recipe, e.measured_us, e.provenance = recipe, measured_us, provenance
                self._gen += 1
                return "replaced"
            return "kept"
        self.entries.append(Entry(fingerprint, np.asarray(embedding, dtype=np.float64),
                                  recipe, provenance, measured_us))
        self._by_fp[fingerprint] = len(self.entries) - 1
        self._matrix = None
        self._gen += 1
        return "added"

    def replace_entry(
        self, fingerprint: str, recipe: Recipe,
        measured_us: float | None = None, provenance: str = "",
    ) -> tuple[Recipe, float | None, str]:
        """Unconditionally swap an entry's recipe; returns the previous
        ``(recipe, measured_us, provenance)`` so the caller can restore it.

        ``add`` keeps whichever recipe carries the *smaller* measurement —
        correct for offline seeding, wrong for a hot-swap or rollback where
        the incumbent's stored timing is stale and the caller has just
        re-measured both sides.  The embedding is untouched (same canonical
        nest), and the generation bumps so caches keyed on database state
        expire."""
        self._sync()
        i = self._by_fp.get(fingerprint)
        if i is None:
            raise KeyError(f"no entry for fingerprint {fingerprint!r}")
        e = self.entries[i]
        prev = (e.recipe, e.measured_us, e.provenance)
        e.recipe, e.measured_us, e.provenance = recipe, measured_us, provenance
        self._gen += 1
        return prev

    def lookup_exact(self, fingerprint: str) -> Recipe | None:
        """The recipe tuned for exactly this fingerprint, or None."""
        self._sync()
        i = self._by_fp.get(fingerprint)
        return self.entries[i].recipe if i is not None else None

    def lookup_nearest(self, embedding: np.ndarray, k: int = 1) -> list[tuple[float, Entry]]:
        """Up to ``k`` nearest entries within ``radius``, as (distance, entry)."""
        self._sync()
        if not self.entries:
            return []
        q = np.asarray(embedding, dtype=np.float64)
        if self._matrix is None or self._matrix.shape[0] != len(self.entries):
            try:
                self._matrix = np.stack(
                    [np.asarray(e.embedding, dtype=np.float64) for e in self.entries]
                )
            except ValueError:  # ragged embeddings: pairwise fallback
                self._matrix = None
        if self._matrix is not None and q.shape == self._matrix.shape[1:]:
            d = np.linalg.norm(self._matrix - q[None, :], axis=1)
        else:
            d = np.array([distance(q, e.embedding) for e in self.entries])
        order = np.argsort(d, kind="stable")[:k]
        return [(float(d[i]), self.entries[i]) for i in order if d[i] <= self.radius]

    def merge(self, other: "TuningDatabase") -> dict[str, int]:
        """Fold ``other``'s entries into this database.

        Incremental tuning runs compose: per fingerprint the better-measured
        recipe wins (the same rule ``add`` applies), unknown fingerprints are
        appended, tuning-run histories (``meta['runs']``) concatenate, and
        ``other``'s remaining meta fills in missing keys.  Databases tuned
        for different backends refuse to merge — their measurements were
        taken under different lowerings and do not rank against each other.
        Returns a report ``{'added': n, 'improved': n, 'kept': n}``.
        """
        mine = self.meta.get("backend")
        theirs = other.meta.get("backend")
        if mine and theirs and mine != theirs:
            raise ValueError(
                f"refusing to merge databases tuned for different backends "
                f"({mine!r} vs {theirs!r}): their measurements do not rank "
                "against each other"
            )
        report = {"added": 0, "improved": 0, "kept": 0}
        label = {"added": "added", "replaced": "improved", "kept": "kept"}
        for e in other.entries:
            action = self.add(e.fingerprint, e.embedding, e.recipe,
                              provenance=e.provenance, measured_us=e.measured_us)
            report[label[action]] += 1
        runs = list(self.meta.get("runs", []))
        runs += [r for r in other.meta.get("runs", []) if r not in runs]
        for k, v in other.meta.items():
            self.meta.setdefault(k, v)
        if runs:
            self.meta["runs"] = runs
        return report

    def summary(self) -> dict:
        """Size/provenance report: entry count, recipe-kind and provenance
        histograms, how many entries carry a measurement, and the meta."""
        kinds: dict[str, int] = {}
        prov: dict[str, int] = {}
        for e in self.entries:
            kinds[e.recipe.kind] = kinds.get(e.recipe.kind, 0) + 1
            key = e.provenance.rsplit(":", 1)[-1] if e.provenance else "unknown"
            prov[key] = prov.get(key, 0) + 1
        return {
            "entries": len(self.entries),
            "measured": sum(1 for e in self.entries if e.measured_us is not None),
            "kinds": dict(sorted(kinds.items())),
            "provenance": dict(sorted(prov.items())),
            "meta": dict(self.meta),
        }

    def lookup(self, fingerprint: str, embedding: np.ndarray) -> tuple[Recipe | None, str]:
        """Exact-then-nearest lookup; returns (recipe-or-None, provenance)."""
        r = self.lookup_exact(fingerprint)
        if r is not None:
            return r, "exact"
        near = self.lookup_nearest(embedding)
        if near:
            return near[0][1].recipe, f"transfer(d={near[0][0]:.2f})"
        return None, "miss"

    # -- persistence ---------------------------------------------------------
    #
    # Durability contract: ``save`` is atomic (tmp + fsync + ``os.replace``)
    # so a reader never sees a half-written file, the document carries a
    # content checksum so bit rot / manual edits / torn copies are *detected*
    # rather than silently deserialized, and each successful save refreshes a
    # ``.bak`` sibling that ``load`` falls back to when the primary is
    # corrupt.  The tuning pool checkpoints through ``save`` after every
    # completed nest, so this path must survive being interrupted at any
    # instruction.

    @staticmethod
    def _checksum(doc: dict) -> str:
        """Content checksum over the canonical (sorted-key, compact) JSON of
        everything except the checksum field itself."""
        body = {k: v for k, v in doc.items() if k != "checksum"}
        blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    @staticmethod
    def _write_atomic(path: Path, text: str) -> None:
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def save(self, path: str | Path) -> None:
        """Atomically persist to JSON (checksum + ``.bak`` refresh on success)."""
        data = [
            {
                "fingerprint": e.fingerprint,
                "embedding": e.embedding.tolist(),
                "recipe": e.recipe.to_json(),
                "provenance": e.provenance,
                # inf/nan would serialize as the non-JSON token 'Infinity'
                "measured_us": e.measured_us
                if e.measured_us is not None and math.isfinite(e.measured_us)
                else None,
            }
            for e in self.entries
        ]
        doc = {"version": SCHEMA_VERSION, "radius": self.radius, "entries": data}
        if self.meta:
            doc["meta"] = self.meta
        doc["checksum"] = self._checksum(doc)
        path = Path(path)
        text = json.dumps(doc, indent=1)
        self._write_atomic(path, text)
        # second copy only after the primary landed: the .bak always holds a
        # complete, checksummed document from some successful save
        self._write_atomic(path.with_suffix(path.suffix + ".bak"), text)

    @staticmethod
    def _parse(path: Path) -> dict:
        raw = json.loads(path.read_text())
        if not isinstance(raw, dict) or "entries" not in raw:
            raise DatabaseCorruption(f"{path}: not a tuning-database document")
        stored = raw.get("checksum")
        if stored is not None and stored != TuningDatabase._checksum(raw):
            raise DatabaseCorruption(f"{path}: content checksum mismatch")
        return raw

    @staticmethod
    def load(path: str | Path) -> "TuningDatabase":
        """Load a database, recovering from corruption via the ``.bak``.

        A primary that fails to parse or fails its checksum is reported on
        stderr and the ``.bak`` sibling (written on every successful save)
        is tried; :class:`DatabaseCorruption` is raised only when both are
        unreadable.  A version newer than this code supports is *not*
        corruption and raises ``ValueError`` immediately.
        """
        path = Path(path)
        bak = path.with_suffix(path.suffix + ".bak")
        try:
            raw = TuningDatabase._parse(path)
        except (json.JSONDecodeError, DatabaseCorruption, KeyError) as primary_err:
            if not bak.exists():
                raise DatabaseCorruption(
                    f"{path}: unreadable ({primary_err}) and no .bak exists"
                ) from primary_err
            print(f"WARNING: {path} is corrupt ({primary_err}); "
                  f"recovering from {bak.name}", file=sys.stderr)
            try:
                raw = TuningDatabase._parse(bak)
            except (json.JSONDecodeError, DatabaseCorruption, KeyError) as bak_err:
                raise DatabaseCorruption(
                    f"{path}: both primary ({primary_err}) and backup "
                    f"({bak_err}) are unreadable"
                ) from primary_err
        version = raw.get("version", 1)  # v1 files carry no version field
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"{path}: database version {version} is newer than supported "
                f"({SCHEMA_VERSION})"
            )
        db = TuningDatabase(radius=raw.get("radius", 6.0), meta=raw.get("meta", {}))
        for d in raw["entries"]:
            db.entries.append(
                Entry(d["fingerprint"], np.asarray(d["embedding"]),
                      Recipe.from_json(d["recipe"]), d.get("provenance", ""),
                      d.get("measured_us"))
            )
        db._reindex()
        return db
