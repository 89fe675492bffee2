"""State carried across: the reference's tuning database loads into the port
and resolves the same recipe, with the same provenance, for every nest."""
import numpy as np
import pytest
import torch

from repro.core import Daisy as RDaisy
from repro.core import TuningDatabase as RDatabase
from repro.core.database import default_pretuned_path as r_default_path
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.core import Daisy, Recipe, TuningDatabase
from repro_torch.core.database import default_pretuned_path
from repro_torch.polybench import BENCHMARKS, NAMES

torch.set_num_threads(1)


def test_pretuned_path_is_the_shipped_file():
    assert default_pretuned_path("xla") == r_default_path("xla")
    db = TuningDatabase.load(default_pretuned_path("xla"))
    assert len(db.entries) == 56
    assert {e.recipe.kind for e in db.entries} == {"einsum", "vectorize"}


@pytest.fixture(scope="module")
def daisies():
    port = Daisy(db=TuningDatabase.load(default_pretuned_path("xla")), backend="torch",
                 device="cpu")
    return port, RDaisy.pretuned(backend="xla")


@pytest.mark.parametrize("name", NAMES)
def test_pretuned_plans_match_reference(daisies, name):
    port, ref = daisies
    for variant in ("a", "b", "np"):
        pp = port.plan(BENCHMARKS[name].make(variant, "bench"))
        rp = ref.plan(R_BENCH[name].make(variant, "bench"))
        got = [(n.fingerprint, n.idiom, n.recipe.to_json(), n.source) for n in pp.nests]
        want = [(n.fingerprint, n.idiom, n.recipe.to_json(), n.source) for n in rp.nests]
        assert got == want, variant
        assert any(n.source == "exact" for n in pp.nests)


def test_port_database_saves_what_the_reference_loads(tmp_path):
    db = TuningDatabase.load(default_pretuned_path("xla"))
    db.add("fp-new", np.arange(4.0), Recipe(kind="pallas_nest", tile=(8, 128), unroll=2),
           provenance="port", measured_us=12.5)
    path = tmp_path / "db.json"
    db.save(path)
    back = RDatabase.load(path)
    assert len(back.entries) == len(db.entries)
    assert back.lookup_exact("fp-new").to_json() == db.lookup_exact("fp-new").to_json()
    again = TuningDatabase.load(path)
    assert [e.fingerprint for e in again.entries] == [e.fingerprint for e in db.entries]
