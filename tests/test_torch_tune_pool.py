"""The tune CLI's spawn pool on the CPU: the same nests as the in-process
run, and an injected worker crash or hang retried, then quarantined, then
skipped until ``retry_quarantined``, without losing the other nests.

Each pool round starts fresh ``spawn`` workers (CUDA does not survive a
fork), which import torch, so these tests take seconds each; the hang case
waits out the progress timeout and has a file of its own,
``test_torch_tune_hang.py``, so that no file nears a minute.
"""
import pytest
import torch

from repro_torch.fault import Fault, FaultPlan
from repro_torch.tools import tune as T

torch.set_num_threads(1)

KW = dict(suite="polybench", names=["gemm"], size="mini", backend="cuda", device="cpu",
          iterations=1, population=2, repeats=1, search=False, verbose=False)
@pytest.fixture(scope="module")
def inline(tmp_path_factory):
    db, _ = T.tune(jobs=1, out=tmp_path_factory.mktemp("inline") / "db.json", **KW)
    return db


def test_spawn_pool_matches_inline(tmp_path, inline):
    pooled, _ = T.tune(jobs=2, out=tmp_path / "pooled.json", **KW)
    assert len(inline.entries) == 2
    assert sorted((e.fingerprint, e.recipe.to_json()["kind"], e.provenance)
                  for e in pooled.entries) == \
        sorted((e.fingerprint, e.recipe.to_json()["kind"], e.provenance) for e in inline.entries)


def pool_fault_round(tmp_path, fps, kind, retries, fires, timeout_s=None):
    """A pool run with ``kind`` striking the first nest on every attempt: it is
    quarantined after ``fires`` attempts, the other nest lands, later runs
    skip the quarantined nest until ``retry_quarantined``."""
    bad, good = fps
    plan = FaultPlan([Fault("tune.worker", kind, key=bad, times=-1)])
    db, out = T.tune(jobs=2, out=tmp_path / "db.json", fault_plan=plan,
                     max_task_retries=retries, task_timeout_s=timeout_s, **KW)
    assert plan.count("tune.worker") == fires
    assert bad in db.meta["quarantined"] and db.lookup_exact(bad) is None
    assert db.lookup_exact(good) is not None, "an innocent nest was lost by association"
    # the record holds in later runs (in-process here: no pool is needed)
    db, _ = T.tune(jobs=1, out=out, **KW)  # no fault now, but still quarantined
    assert db.lookup_exact(bad) is None and bad in db.meta["quarantined"]
    assert db.meta["nests_tuned"] == 0
    db, _ = T.tune(jobs=1, out=out, retry_quarantined=True, **KW)
    assert db.lookup_exact(bad) is not None and "quarantined" not in db.meta


def test_pool_crash_is_retried_then_quarantined(tmp_path, inline):
    pool_fault_round(tmp_path, [e.fingerprint for e in inline.entries], "crash",
                     retries=1, fires=2)
