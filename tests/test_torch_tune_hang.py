"""The tune CLI's spawn pool on the CPU: a worker that hangs stalls the pool
past its progress timeout, is killed, and its nest is quarantined, then
skipped until ``retry_quarantined``; the other nest lands.

The timeout has to outlast a healthy round (two spawn workers importing
torch, then a mini measurement) on a loaded machine, so this test waits
about half a minute.
"""
import pytest
import torch

from repro_torch.tools import tune as T
from test_torch_tune_pool import KW, pool_fault_round

torch.set_num_threads(1)

STALL_S = 30.0


@pytest.fixture(scope="module")
def fps(tmp_path_factory):
    db, _ = T.tune(jobs=1, out=tmp_path_factory.mktemp("inline") / "db.json", **KW)
    return [e.fingerprint for e in db.entries]


def test_pool_hang_is_stalled_then_quarantined(tmp_path, fps):
    pool_fault_round(tmp_path, fps, "hang", retries=0, fires=1, timeout_s=STALL_S)
