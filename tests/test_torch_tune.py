"""The port's tune CLI and explain tool against the reference, on the CPU.

``tune`` at mini sizes on the CPU (``device='cpu'``, the kernels' plain
versions): the database it writes, ``Daisy.pretuned`` over it, incremental
runs, the CLI, the in-process supervision (an injected worker error is
retried, then quarantined, then skipped until ``retry_quarantined``; a lost
card ends the run), the nests it enumerates at ``all``/``bench`` against
the reference's shipped database, the shipped ``data/pretuned_cuda.json``,
and ``tools/explain`` line for line against the reference's.  The spawn
pool's crash handling is in ``test_torch_tune_pool.py``, its hang handling
in ``test_torch_tune_hang.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro import autotune as r_autotune
from repro.core import Daisy as RDaisy
from repro.core import fingerprint as r_fingerprint
from repro.core.database import default_pretuned_path as r_default_path
from repro.polybench import BENCHMARKS as R_BENCH
from repro.tools import explain as r_explain
from repro_torch import autotune
from repro_torch.core import Daisy, TuningDatabase, fingerprint, normalize
from repro_torch.core.database import default_pretuned_path
from repro_torch.core.scheduler import random_inputs
from repro_torch.fault import Fault, FaultPlan
from repro_torch.polybench import BENCHMARKS
from repro_torch.tools import explain as p_explain
from repro_torch.tools import tune as T

torch.set_num_threads(1)

MINI = dict(suite="polybench", size="mini", backend="cuda", device="cpu", jobs=1,
            iterations=1, population=2, repeats=1, verbose=False)


def _tune(tmp_path, **kw):
    args = dict(MINI, names=["gemm"], out=tmp_path / "db.json")
    args.update(kw)
    return T.tune(**args)


def test_program_specs_validates_names():
    assert ("polybench", "gemm") in autotune.program_specs("polybench")
    assert ("cloudsc", "scheme") in autotune.program_specs("all")
    assert autotune.program_specs("cloudsc") == [("cloudsc", "erosion"), ("cloudsc", "scheme")]
    with pytest.raises(SystemExit, match="unknown benchmark"):
        autotune.program_specs("polybench", ["gemm", "nope"])


def test_tune_produces_a_pretuned_database(tmp_path):
    db, path = _tune(tmp_path, names=["gemm", "bicg"], search=False)
    assert path.exists() and db.meta["backend"] == "cuda" and db.meta["device"] == "cpu"
    assert db.meta["card"] == "cpu" and db.meta["wall_s"] >= 0
    assert db.meta["measurements"] == len(db.entries)  # one analytic measurement a nest
    assert all(e.measured_us is not None and np.isfinite(e.measured_us) for e in db.entries)
    d = Daisy.pretuned(path=path, device="cpu")
    prog = BENCHMARKS["gemm"].make("b", "mini")
    fn, plan = d.compile(prog)
    assert all(p.source == "exact" for p in plan.nests)
    assert tuple(fn(random_inputs(prog))["C"].shape) == (20, 24)


def test_tune_searches_kernel_recipes(tmp_path):
    db, _ = _tune(tmp_path, names=["atax", "jacobi-2d"], iterations=2, population=4)
    assert len(db.entries) == 5
    assert db.summary()["provenance"].keys() <= {"search", "search+transfer", "idiom"}
    assert db.meta["runs"][-1]["search_iterations"] == 2
    assert db.meta["measurements"] > 2 * len(db.entries)  # epoch 1 and the transfer epoch


def test_tune_incremental_runs_compose(tmp_path):
    db1, _ = _tune(tmp_path, search=False)
    db2, _ = _tune(tmp_path, names=["gemm", "bicg"], search=False)
    fps1 = {e.fingerprint for e in db1.entries}
    assert fps1 < {e.fingerprint for e in db2.entries}
    for e1 in db1.entries:  # tuned fingerprints are skipped, not re-measured
        e2 = db2.entries[db2._by_fp[e1.fingerprint]]
        assert (e1.recipe, e1.measured_us) == (e2.recipe, e2.measured_us)
    assert [r["names"] for r in db2.meta["runs"]] == [["gemm"], ["gemm", "bicg"]]


def test_tune_main_cli(tmp_path):
    out = tmp_path / "cli.json"
    T.main(["--suite", "polybench", "--names", "gemm", "--size", "mini", "--device", "cpu",
            "--jobs", "0", "--no-search", "--repeats", "1", "--out", str(out)])
    db = TuningDatabase.load(out)
    assert db.entries and db.meta["size"] == "mini" and db.meta["backend"] == "cuda"


def test_tune_refuses_parallel_workers_on_the_card(tmp_path):
    # checked before anything touches a device, so it holds without a card
    with pytest.raises(ValueError, match="jobs=2 on cuda"):
        _tune(tmp_path, device="cuda", jobs=2)
    with pytest.raises(ValueError, match="jobs=3 on cuda:0"):
        T.main(["--names", "gemm", "--size", "mini", "--device", "cuda:0",
                "--jobs", "3", "--out", str(tmp_path / "cli.json")])
    assert not (tmp_path / "db.json").exists() and not (tmp_path / "cli.json").exists()


def test_worker_task_matches_parent_enumeration():
    p = normalize(BENCHMARKS["gemm"].make("a", "mini"))
    task = {"source": "polybench", "name": "gemm", "size": "mini", "nest_index": 1,
            "backend": "cuda", "device": "cpu", "search": False, "iterations": 1,
            "population": 2, "repeats": 1, "fingerprint": fingerprint(p.body[1])}
    r = autotune.tune_nest_task(task)
    assert r["fingerprint"] == fingerprint(p.body[1])
    assert np.isfinite(r["measured_us"]) and r["recipe"]["kind"]
    with pytest.raises(RuntimeError, match="diverged"):
        autotune.tune_nest_task(dict(task, fingerprint="other"))


# ---------------------------------------------------------------------------
# in-process supervision
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gemm_fps(tmp_path_factory):
    db, _ = _tune(tmp_path_factory.mktemp("ref"), search=False)
    return [e.fingerprint for e in db.entries]


def test_transient_error_is_retried_to_success(tmp_path, gemm_fps):
    plan = FaultPlan([Fault("tune.worker", "error", key=gemm_fps[0], times=1)])
    db, _ = _tune(tmp_path, fault_plan=plan, max_task_retries=1, search=False)
    assert db.lookup_exact(gemm_fps[0]) is not None and "quarantined" not in db.meta
    assert plan.fired == [("tune.worker", gemm_fps[0], "error")]


@pytest.mark.parametrize("kind", ("error", "crash", "hang"))
def test_persistent_fault_quarantines_then_skips_until_retry(tmp_path, gemm_fps, kind):
    plan = FaultPlan([Fault("tune.worker", kind, key=gemm_fps[0], times=-1)])
    db, out = _tune(tmp_path, fault_plan=plan, max_task_retries=1, search=False)
    assert plan.count("tune.worker") == 2  # the first attempt and one retry
    assert gemm_fps[0] in db.meta["quarantined"] and db.meta["nests_quarantined"] == 1
    for fp in gemm_fps[1:]:  # the rest of the run survived the poison nest
        assert db.lookup_exact(fp) is not None
        assert TuningDatabase.load(out).lookup_exact(fp) is not None  # checkpointed
    db, _ = _tune(tmp_path, search=False)  # no fault now, but still quarantined
    assert db.lookup_exact(gemm_fps[0]) is None and gemm_fps[0] in db.meta["quarantined"]
    db, _ = _tune(tmp_path, search=False, retry_quarantined=True)
    assert db.lookup_exact(gemm_fps[0]) is not None and "quarantined" not in db.meta


def test_a_lost_card_ends_the_in_process_run(tmp_path, gemm_fps, monkeypatch):
    monkeypatch.setattr(autotune, "_device_lost", lambda task: True)
    plan = FaultPlan([Fault("tune.worker", "error", key=gemm_fps[0])])
    with pytest.raises(autotune.FaultInjected):
        _tune(tmp_path, fault_plan=plan, max_task_retries=3, search=False)


def test_device_lost_is_false_on_the_cpu():
    assert autotune._device_lost({"device": "cpu"}) is False
    assert autotune._device_lost({}) is False


# ---------------------------------------------------------------------------
# what is enumerated, and what ships
# ---------------------------------------------------------------------------
def _reference_enumeration(size: str) -> set[str]:
    d = RDaisy(backend="xla")
    return {r_fingerprint(n) for s, name in r_autotune.program_specs("all")
            for n in d._normalized(r_autotune.build_program(s, name, size)).body}


def _stale(xla_fps: set[str], fps: set[str]) -> set[str]:
    """The shipped reference file's nests that today's pipeline no longer
    produces: the CLOUDSC scheme nest it holds in its pre-CSE form (the file
    predates the rewrite passes)."""
    stale = xla_fps - fps
    assert len(stale) == 1 and len(fps - xla_fps) == 1
    (old,), (new,) = stale, fps - xla_fps
    assert "ZQL" in old and "_cse" not in old and "_cse" in new and "ZQL" in new
    return stale


def test_enumeration_at_bench_is_the_references(tmp_path, monkeypatch):
    seen = []

    def capture(tasks, jobs, verbose, **kw):
        seen.extend(tasks)
        return [], {}

    monkeypatch.setattr(T, "run_supervised", capture)
    T.tune(suite="all", size="bench", backend="cuda", device="cpu", out=tmp_path / "x.json",
           transfer=False, verbose=False)
    fps = {t["fingerprint"] for t in seen}
    assert len(seen) == len(fps) == 56
    assert fps == _reference_enumeration("bench")
    xla = {e.fingerprint for e in TuningDatabase.load(r_default_path("xla")).entries}
    assert len(xla - _stale(xla, fps)) == 55


def test_shipped_cuda_database():
    path = default_pretuned_path("cuda")
    assert path.name == "pretuned_cuda.json"
    db = TuningDatabase.load(path)
    fps = {e.fingerprint for e in db.entries}
    assert fps == _reference_enumeration("bench")
    xla = {e.fingerprint for e in TuningDatabase.load(default_pretuned_path("xla")).entries}
    assert xla - _stale(xla, fps) <= fps
    assert all(e.measured_us is not None and np.isfinite(e.measured_us) and e.measured_us > 0
               for e in db.entries)
    meta = db.meta
    assert meta["backend"] == "cuda" and meta["device"] == "cuda"
    assert (meta["suite"], meta["size"], meta["search_iterations"], meta["population"],
            meta["jobs"], meta["nests_tuned"]) == ("all", "bench", 3, 6, 1, 56)
    assert "H100" in meta["card"] and "quarantined" not in meta
    # every variant's nests resolve exactly against it
    d = Daisy.pretuned(device="cpu")
    for name in ("syrk", "atax", "correlation", "jacobi-2d"):
        for variant in ("a", "b", "np"):
            plan = d.plan(BENCHMARKS[name].make(variant, "bench"))
            assert all(n.source == "exact" for n in plan.nests), (name, variant)


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------
def _without_times(text: str) -> list[str]:
    return [re.sub(r"\s+", " ", re.sub(r"\d+\.\d+ms|-+", "T", line)).strip()
            for line in text.splitlines()]


@pytest.mark.parametrize("name,variant,kw", [
    ("gemm", "a", {}), ("2mm", "np", {"show_ir": True}), ("jacobi-2d", "b", {}),
    ("correlation", "a", {"fuse": False}), ("gemver", "a", {"rewrite": False}),
])
def test_explain_prints_the_reference_lines(name, variant, kw):
    got = p_explain.explain(BENCHMARKS[name].make(variant, "mini"), **kw)
    want = r_explain.explain(R_BENCH[name].make(variant, "mini"), **kw)
    assert _without_times(got) == _without_times(want)
    assert "canonical nests:" in got


@pytest.mark.parametrize("program", ("cloudsc_erosion", "cloudsc_scheme", "saturation_chain"))
def test_explain_cli_on_cloudsc(program, capsys, monkeypatch):
    p_explain.main([program, "--no-rewrite"])
    got = capsys.readouterr().out
    want = r_explain.explain(r_explain.EXTRA[program]("mini"), rewrite=False)
    assert _without_times(got.rstrip("\n")) == _without_times(want)
