"""Offline transfer tuning: seed the recipe database from the A variants.

Usage (on the card):
    PYTHONPATH=src python -m repro_torch.tools.tune --suite all --size bench \
        --backend cuda --jobs 1 --iterations 3 --population 6 \
        --out data/pretuned_cuda.json
    PYTHONPATH=src python -m repro_torch.tools.tune --suite polybench \
        --size mini --device cpu --jobs 2     # the plain versions, on the CPU

Port of ``repro/tools/tune.py``.  Runs ``Daisy.seed``'s evolutionary search
(paper §4, "Seeding a Scheduling Database") over the selected suite — the
PolyBench A variants and/or the two CLOUDSC programs — one epoch-1 search
per canonical nest, then the cross-nest transfer epoch (the paper's epochs
2-3) in the parent, and persists the database.  Every candidate is timed on
``--device`` under the lowering ``--backend`` executes: under ``cuda`` each
kernel candidate is built and launched on the card.

Re-running against an existing ``--out`` composes: the file is loaded
first, already-tuned fingerprints are skipped, and new results merge in
(per fingerprint the better-measured recipe wins).  The written file is
what ``Daisy.pretuned(backend=...)`` loads at deployment time; its ``meta``
records the run's arguments, its wall time, the candidate measurements it
took and, on the card, the card's name and power limit as ``nvidia-smi``
prints them.

The pool is supervised (``repro_torch.autotune.run_supervised``):

  * every completed nest is **checkpointed** into ``--out`` as it lands, so
    a crashed run loses nothing already measured and a re-run resumes;
  * a worker error, death or stall (no completion within
    ``--task-timeout``) is retried with bounded backoff;
  * a nest that keeps failing is **quarantined** by fingerprint — recorded
    under ``meta["quarantined"]`` and skipped by future runs until
    ``--retry-quarantined``.  A kernel that fails to build or launch is
    such a failure, never a slow candidate.

Workers that time on one card at once corrupt each other's fitness, so on
the card ``tune`` refuses ``--jobs`` above 1 and runs in-process.
Deterministic fault injection: a ``fault.FaultPlan`` with site
``tune.worker`` (key = nest fingerprint) makes the matching worker crash,
hang, or raise — how the supervision is tested.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..autotune import BACKENDS, SUITES, build_program, program_specs, run_supervised
from ..core import Daisy, Program, TuningDatabase, fingerprint
from ..core import search as core_search
from ..core.database import pretuned_dir
from ..core.recipes import Recipe
from ..fault import FaultPlan


def card_line(device: str | torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, ``"cpu"`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"


def tune(
    suite: str = "all",
    size: str = "mini",
    backend: str = "cuda",
    out: str | Path | None = None,
    names: list[str] | None = None,
    jobs: int = 1,
    iterations: int = 2,
    population: int = 4,
    repeats: int = 3,
    search: bool = True,
    transfer: bool = True,
    verbose: bool = True,
    task_timeout_s: float | None = None,
    max_task_retries: int = 1,
    retry_quarantined: bool = False,
    fault_plan: FaultPlan | None = None,
    device: str = "cuda",
) -> tuple[TuningDatabase, Path]:
    """Tune the suite on ``device`` and persist/merge the database at ``out``.

    Raises ``ValueError`` for ``jobs > 1`` on a CUDA device: workers timing
    on one card at once would write a database of corrupted fitness.
    """
    if jobs > 1 and torch.device(device).type == "cuda":
        raise ValueError(f"jobs={jobs} on {device}: workers would time on one "
                         f"card at once; tune on the card with jobs=1")
    t_start = time.perf_counter()
    out = Path(out) if out is not None else pretuned_dir() / f"pretuned_{backend}.json"
    db = TuningDatabase.load(out) if out.exists() else TuningDatabase()
    before = len(db.entries)
    if retry_quarantined:
        db.meta.pop("quarantined", None)
    quarantine_meta: dict = db.meta.get("quarantined", {})

    # enumerate distinct canonical nests (normalization is pure IR work —
    # nothing runs on a device in the parent before the pool spins up)
    scout = Daisy(backend=backend, device=device)
    specs = program_specs(suite, names)
    progs: list[Program] = []
    tasks: list[dict] = []
    seen: set[str] = set()
    skipped_quarantined = 0
    for source, name in specs:
        prog = build_program(source, name, size)
        progs.append(prog)
        p = scout._normalized(prog)
        for i, nest in enumerate(p.body):
            fp = fingerprint(nest)
            if fp in seen or db.lookup_exact(fp) is not None:
                continue
            if fp in quarantine_meta:
                skipped_quarantined += 1
                continue
            seen.add(fp)
            tasks.append({
                "source": source, "name": name, "size": size, "nest_index": i,
                "backend": backend, "device": device, "search": search,
                "iterations": iterations, "population": population,
                "repeats": repeats, "fingerprint": fp,
            })
    if verbose:
        quar = (f", {skipped_quarantined} quarantined"
                if skipped_quarantined else "")
        print(f"tuning {len(tasks)} nests ({len(specs)} programs, suite={suite}, "
              f"size={size}, backend={backend}, device={device}, jobs={jobs}, "
              f"{before} entries already tuned{quar})", flush=True)

    out.parent.mkdir(parents=True, exist_ok=True)

    def accept(r: dict) -> bool:
        if not np.isfinite(r["measured_us"]):
            # every candidate was refused before launch for this nest: ship
            # no entry (plan() falls back to the default recipe)
            print(f"  WARNING: no measurable lowering for {r['provenance']} "
                  f"({r['fingerprint'][:50]}); skipped")
            return False
        db.add(r["fingerprint"], np.asarray(r["embedding"]),
               Recipe.from_json(r["recipe"]),
               provenance=r["provenance"], measured_us=r["measured_us"])
        return True

    def on_result(t: dict, r: dict) -> None:
        if accept(r):
            # in-run checkpoint: a completed nest survives any later pool
            # loss, and a re-run against --out resumes past it
            db.save(out)

    # epoch 1 under supervision
    t0 = time.perf_counter()
    results, quarantined = run_supervised(
        tasks, jobs, verbose, on_result=on_result,
        task_timeout_s=task_timeout_s, max_task_retries=max_task_retries,
        fault_plan=fault_plan,
    )
    if quarantined:
        q = db.meta.setdefault("quarantined", {})
        for fp, reason in quarantined.items():
            q[fp] = {"reason": reason,
                     "at": time.strftime("%Y-%m-%dT%H:%M:%S")}

    # epochs 2-3 (cross-nest transfer) need the merged database: run in the
    # parent, restricted to this run's nests so incremental runs compose
    # (quarantined nests excluded — a recipe that kills workers must not be
    # re-run in the parent process)
    measurements = sum(r["measurements"] for r in results)
    if transfer and search and tasks:
        d = Daisy(db=db, backend=backend, device=device)
        before_transfer = core_search.COUNTS["measurements"]
        n = d.transfer_epoch(progs, fingerprints=seen - set(quarantined),
                             repeats=repeats)
        measurements += core_search.COUNTS["measurements"] - before_transfer
        if verbose:
            print(f"transfer epoch re-seeded {n} nests", flush=True)

    # last run's coordinates at the top level, full history under "runs"
    # (incremental runs compose — a single suite/size would misdescribe
    # a database tuned across several)
    run_rec = {
        "suite": suite, "size": size, "backend": backend,
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "search_iterations": iterations, "population": population,
        "nests_tuned": len(tasks),
        "device": device, "card": card_line(device), "jobs": jobs,
        "repeats": repeats, "search": search, "transfer": transfer,
        "names": names, "measurements": measurements,
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    if quarantined:
        run_rec["nests_quarantined"] = len(quarantined)
    db.meta.update(run_rec)
    db.meta.setdefault("runs", []).append(run_rec)
    db.save(out)
    if verbose:
        s = db.summary()
        print(f"wrote {out} in {time.perf_counter() - t0:.0f}s "
              f"({run_rec['wall_s']} s in all, {measurements} measurements): "
              f"{s['entries']} entries (+{s['entries'] - before}), "
              f"{s['measured']} measured")
        print(f"  kinds: {s['kinds']}")
        print(f"  provenance: {s['provenance']}")
    return db, out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", default="all", choices=SUITES)
    ap.add_argument("--size", default="mini", choices=["mini", "bench"])
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="measure under the lowering this backend executes")
    ap.add_argument("--device", default="cuda",
                    help="where candidates run: the card (default) or 'cpu' "
                         "(the kernels' plain versions)")
    ap.add_argument("--out", default=None,
                    help="database path (default: data/pretuned_<backend>.json; "
                         "an existing file is merged into, not overwritten)")
    ap.add_argument("--names", default=None,
                    help="comma-separated polybench subset (e.g. gemm,bicg)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="process-pool width for the per-nest searches "
                         "(default: 1 on the card, min(4, cpu count) on the "
                         "CPU; <=1 runs in-process)")
    ap.add_argument("--iterations", type=int, default=2,
                    help="evolutionary search iterations per nest (epoch 1)")
    ap.add_argument("--population", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per candidate measurement")
    ap.add_argument("--no-search", dest="search", action="store_false",
                    help="analytic seeding only (idiom default recipes, measured)")
    ap.add_argument("--no-transfer", dest="transfer", action="store_false",
                    help="skip the cross-nest transfer epoch")
    ap.add_argument("--task-timeout", type=float, default=None,
                    help="progress timeout in seconds: if no nest completes "
                         "within it, in-flight workers are presumed hung, "
                         "killed and their tasks retried")
    ap.add_argument("--max-task-retries", type=int, default=1,
                    help="failed attempts per nest before it is quarantined")
    ap.add_argument("--retry-quarantined", action="store_true",
                    help="give nests recorded in meta['quarantined'] "
                         "another chance instead of skipping them")
    args = ap.parse_args(argv)
    if args.jobs is not None:
        jobs = args.jobs
    else:
        jobs = 1 if torch.device(args.device).type == "cuda" else min(4, os.cpu_count() or 1)
    tune(
        suite=args.suite, size=args.size, backend=args.backend, out=args.out,
        names=args.names.split(",") if args.names else None, jobs=jobs,
        iterations=args.iterations, population=args.population,
        repeats=args.repeats, search=args.search, transfer=args.transfer,
        task_timeout_s=args.task_timeout,
        max_task_retries=args.max_task_retries,
        retry_quarantined=args.retry_quarantined, device=args.device,
    )


if __name__ == "__main__":
    main()
