"""The port's evolutionary search, seeding and database operations against the
reference's, on the CPU at mini sizes.

With one deterministic fitness patched into both packages (a hash of the
candidate's JSON), the mutation stream, ``evolve_recipe`` and ``Daisy.seed``
must walk the same candidates and produce identical databases, under the
reference's ``xla`` against the port's ``torch`` and the reference's
``pallas_interpret`` against the port's ``cuda`` (on the CPU).  A database
seeded with real CPU timing must transfer onto the b and np variants with
correct outputs.  ``measure_recipe`` returns ``inf`` only for a refusal
before launch or a non-finite time; a kernel error propagates.
"""
import json
import random
import zlib

import numpy as np
import pytest
import torch

from repro.core import Daisy as RDaisy
from repro.core import TuningDatabase as RDatabase
from repro.core import execute_numpy as r_execute_numpy
from repro.core import search as rsearch
from repro.core import scheduler as rsched
from repro.core.recipes import Recipe as RRecipe
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.core import Daisy, Recipe, TuningDatabase, execute_numpy, fingerprint
from repro_torch.core import scheduler as psched
from repro_torch.core import search as psearch
from repro_torch.core.codegen import Unsupported
from repro_torch.core.scheduler import nest_program, random_inputs
from repro_torch.core.tiling import TilingError
from repro_torch.kernels import nest_kernel
from repro_torch.polybench import BENCHMARKS

torch.set_num_threads(1)

SEED_SET = ("gemm", "atax", "jacobi-2d", "correlation")
FINGERPRINTS = ("", "L[t0:0:8:1](C(x[t0]=y[t0]|))", "gemm:nest", "a" * 300)
SEEDS = (
    dict(kind="einsum"), dict(kind="vectorize"), dict(kind="sequential"),
    dict(kind="pallas_gemm", tile=(128, 128, 128)),
    dict(kind="pallas_nest", tile=(8, 128), unroll=2),
    dict(kind="pallas_reduce", tile=(8, 128, 128)),
)


def fitness(recipe) -> float:
    """A deterministic stand-in for a measured time: a hash of the JSON."""
    blob = json.dumps(recipe.to_json(), sort_keys=True).encode()
    return 1.0 + zlib.crc32(blob) % 997


@pytest.fixture
def hashed(monkeypatch):
    """Patch both packages' measurement to ``fitness``; returns the logs of
    the candidates each package timed."""
    logs = {"ref": [], "port": []}

    def fake(log):
        def measure(prog, inputs, recipe, **kw):
            log.append(recipe.to_json())
            return fitness(recipe)
        return measure

    for mod in (rsearch, rsched):
        monkeypatch.setattr(mod, "measure_recipe", fake(logs["ref"]))
    for mod in (psearch, psched):
        monkeypatch.setattr(mod, "measure_recipe", fake(logs["port"]))
    return logs


@pytest.mark.parametrize("fp", FINGERPRINTS)
def test_nest_rng_seed_is_the_reference(fp):
    for salt in ("", "transfer:"):
        assert psearch.nest_rng_seed(fp, salt) == rsearch.nest_rng_seed(fp, salt)


@pytest.mark.parametrize("seed", SEEDS, ids=[s["kind"] for s in SEEDS])
@pytest.mark.parametrize("fp", FINGERPRINTS[1:])
def test_mutation_stream_is_the_reference(seed, fp):
    r_rng = random.Random(rsearch.nest_rng_seed(fp))
    p_rng = random.Random(psearch.nest_rng_seed(fp))
    r, p = RRecipe(**seed), Recipe(**seed)
    got, want = [], []
    for _ in range(200):
        r, p = rsearch._mutate(r, r_rng), psearch._mutate(p, p_rng)
        want.append(r.to_json())
        got.append(p.to_json())
    assert got == want
    assert len({json.dumps(g, sort_keys=True) for g in got}) > 5


@pytest.mark.parametrize("seed", SEEDS, ids=[s["kind"] for s in SEEDS])
def test_evolve_recipe_matches_reference(hashed, seed):
    prog = BENCHMARKS["atax"].make("a", "mini")
    rprog = R_BENCH["atax"].make("a", "mini")
    kw = dict(iterations=3, population=6, rng_seed=psearch.nest_rng_seed("atax"))
    pool = [Recipe(kind="vectorize", vec_budget=1 << 18), Recipe(kind="einsum")]
    rpool = [RRecipe(kind="vectorize", vec_budget=1 << 18), RRecipe(kind="einsum")]
    best, t = psearch.evolve_recipe(prog, {}, Recipe(**seed), reseed_pool=pool,
                                    device="cpu", **kw)
    rbest, rt = rsearch.evolve_recipe(rprog, {}, RRecipe(**seed), reseed_pool=rpool, **kw)
    assert (best.to_json(), t) == (rbest.to_json(), rt)
    assert hashed["port"] == hashed["ref"]
    assert t == min(fitness(Recipe.from_json(j)) for j in hashed["port"])


def test_evolve_recipe_deadline_zero_returns_the_seed(hashed):
    seed = Recipe(kind="vectorize")
    best, t = psearch.evolve_recipe(BENCHMARKS["gemm"].make("a", "mini"), {}, seed,
                                    iterations=5, population=8, deadline_s=0, device="cpu")
    assert best == seed and t == fitness(seed)
    assert hashed["port"] == [seed.to_json()]


def _entries(db):
    return [(e.fingerprint, e.recipe.to_json(), e.provenance, e.measured_us)
            for e in db.entries]


@pytest.mark.parametrize("ref_backend,backend", [("xla", "torch"),
                                                  ("pallas_interpret", "cuda")])
def test_seed_matches_reference(hashed, ref_backend, backend):
    port = Daisy(backend=backend, device="cpu")
    ref = RDaisy(backend=ref_backend)
    port.seed([BENCHMARKS[n].make("a", "mini") for n in SEED_SET])
    ref.seed([R_BENCH[n].make("a", "mini") for n in SEED_SET])
    assert _entries(port.db) == _entries(ref.db)
    assert len(port.db.entries) == 16
    for e, f in zip(port.db.entries, ref.db.entries):
        np.testing.assert_array_equal(e.embedding, f.embedding)
    kinds = {e.recipe.kind for e in port.db.entries}
    if backend == "torch":  # kernel winners stored as their degradations
        assert not any(k.startswith("pallas") for k in kinds)
    assert hashed["port"] == hashed["ref"]


def test_seed_nest_and_transfer_epoch_match_reference(hashed):
    port = Daisy(backend="cuda", device="cpu")
    ref = RDaisy(backend="pallas_interpret")
    p = port._normalized(BENCHMARKS["correlation"].make("a", "mini"))
    rp = ref._normalized(R_BENCH["correlation"].make("a", "mini"))
    for nest, rnest in zip(p.body, rp.body):
        got = port.seed_nest(p, nest, search_iterations=2, population=4)
        want = ref.seed_nest(rp, rnest, search_iterations=2, population=4)
        assert (got[0], got[2].to_json(), got[3], got[4]) == \
            (want[0], want[2].to_json(), want[3], want[4])
        port.db.add(got[0], got[1], got[2], provenance=got[4], measured_us=got[3])
        ref.db.add(want[0], want[1], want[2], provenance=want[4], measured_us=want[3])
    n = port.transfer_epoch([BENCHMARKS["correlation"].make("a", "mini")])
    assert n == ref.transfer_epoch([R_BENCH["correlation"].make("a", "mini")]) > 0
    assert _entries(port.db) == _entries(ref.db)
    assert hashed["port"] == hashed["ref"]


# ---------------------------------------------------------------------------
# transfer with real CPU timing
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    d = Daisy(backend="cuda", device="cpu")
    d.seed([BENCHMARKS[n].make("a", "mini") for n in SEED_SET],
           search_iterations=1, population=2, repeats=1)
    path = tmp_path_factory.mktemp("db") / "seeded.json"
    d.db.save(path)
    return d, RDaisy(db=RDatabase.load(path), backend="xla")


def test_seeded_database_is_measured(seeded):
    d, _ = seeded
    assert len(d.db.entries) == 16
    assert all(np.isfinite(e.measured_us) and e.measured_us > 0 for e in d.db.entries)
    assert {e.provenance.rsplit(":", 1)[-1] for e in d.db.entries} <= \
        {"idiom", "search", "search+transfer"}


@pytest.mark.parametrize("name", SEED_SET)
@pytest.mark.parametrize("variant", ("b", "np"))
def test_transfer_compiles_b_and_np_variants(seeded, name, variant):
    d, ref = seeded
    b = BENCHMARKS[name]
    prog = b.make(variant, "mini")
    fn, plan = d.compile(prog)
    assert all(n.source == "exact" for n in plan.nests)
    inp = random_inputs(prog, seed=17)
    out = fn(inp)[b.output].numpy().astype(np.float64)
    oracle = execute_numpy(prog, {k: v.astype(np.float64) for k, v in inp.items()})
    np.testing.assert_allclose(out, oracle[b.output], rtol=2e-3, atol=2e-3)
    rprog = R_BENCH[name].make(variant, "mini")
    rfn, rplan = ref.compile(rprog)
    assert [(n.fingerprint, n.recipe.to_json(), n.source) for n in plan.nests] == \
        [(n.fingerprint, n.recipe.to_json(), n.source) for n in rplan.nests]
    want = np.asarray(rfn(inp)[b.output], np.float64)
    np.testing.assert_allclose(out, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        r_execute_numpy(rprog, {k: v.astype(np.float64) for k, v in inp.items()})[b.output],
        oracle[b.output])


@pytest.mark.parametrize("name", SEED_SET)
def test_a_and_b_get_identical_schedules(seeded, name):
    d, _ = seeded
    b = BENCHMARKS[name]
    sched = [sorted((n.fingerprint, n.recipe.to_json()["kind"], n.source)
                    for n in d.plan(b.make(v, "mini")).nests) for v in ("a", "b")]
    assert sched[0] == sched[1]


# ---------------------------------------------------------------------------
# the database operations
# ---------------------------------------------------------------------------
def _pair(entries, meta):
    port, ref = TuningDatabase(meta=dict(meta)), RDatabase(meta=dict(meta))
    for fp, emb, kind, t, prov in entries:
        port.add(fp, np.asarray(emb, float), Recipe(kind=kind), provenance=prov, measured_us=t)
        ref.add(fp, np.asarray(emb, float), RRecipe(kind=kind), provenance=prov, measured_us=t)
    return port, ref


A = [("f1", [0, 1], "einsum", 5.0, "gemm:idiom"), ("f2", [1, 1], "vectorize", None, "x"),
     ("f3", [2, 0], "pallas_nest", 9.0, "atax:search")]
B = [("f1", [0, 1], "vectorize", 3.0, "b:search"), ("f2", [1, 1], "einsum", 7.0, "b:analytic"),
     ("f4", [5, 5], "pallas_reduce", 1.0, "b:search+transfer"), ("f3", [2, 0], "einsum", 10.0, "")]


def test_merge_summary_replace_match_reference(tmp_path):
    a, ra = _pair(A, {"backend": "cuda", "runs": [{"n": 1}], "suite": "polybench"})
    b, rb = _pair(B, {"backend": "cuda", "runs": [{"n": 1}, {"n": 2}], "size": "bench"})
    assert a.merge(b) == ra.merge(rb) == {"added": 1, "improved": 2, "kept": 1}
    assert _entries(a) == _entries(ra)
    assert a.meta == ra.meta and a.meta["runs"] == [{"n": 1}, {"n": 2}]
    assert a.summary() == ra.summary()
    prev = a.replace_entry("f1", Recipe(kind="sequential"), 99.0, "hot-swap")
    rprev = ra.replace_entry("f1", RRecipe(kind="sequential"), 99.0, "hot-swap")
    assert (prev[0].to_json(), *prev[1:]) == (rprev[0].to_json(), *rprev[1:])
    assert _entries(a) == _entries(ra)
    g = a.generation
    a.replace_entry("f1", *prev)
    assert a.generation == g + 1 and a.lookup_exact("f1").kind == "vectorize"
    with pytest.raises(KeyError):
        a.replace_entry("nope", Recipe(kind="einsum"))
    x, _ = _pair(A, {"backend": "torch"})
    with pytest.raises(ValueError, match="different backends"):
        x.merge(b)
    # files written by either package load in the other
    a.save(tmp_path / "port.json")
    ra.save(tmp_path / "ref.json")
    assert _entries(RDatabase.load(tmp_path / "port.json")) == _entries(a)
    assert _entries(TuningDatabase.load(tmp_path / "ref.json")) == _entries(ra)
    assert TuningDatabase.load(tmp_path / "ref.json").meta == ra.meta


def test_pretuned_defaults_to_cuda(tmp_path, monkeypatch):
    from repro_torch.core import database as pdb

    monkeypatch.setenv(pdb.PRETUNED_DIR_ENV, str(tmp_path))
    assert pdb.try_load_pretuned() is None
    with pytest.raises(FileNotFoundError, match="repro_torch.tools.tune"):
        pdb.default_pretuned_path()
    db, _ = _pair(A, {"backend": "cuda"})
    db.save(tmp_path / "pretuned_cuda.json")
    assert pdb.default_pretuned_path() == tmp_path / "pretuned_cuda.json"
    assert _entries(pdb.try_load_pretuned()) == _entries(db)
    d = Daisy.pretuned(device="cpu")
    assert d.backend == "cuda" and len(d.db.entries) == 3
    with pytest.raises(FileNotFoundError):
        Daisy.pretuned(backend="torch", device="cpu")


# ---------------------------------------------------------------------------
# measure_recipe: inf only before launch or for a non-finite time
# ---------------------------------------------------------------------------
def _atax_nests():
    d = Daisy(backend="cuda", device="cpu")
    p = d._normalized(BENCHMARKS["atax"].make("a", "mini"))
    return [(nest_program(p, n), n) for n in p.body]


def test_measure_recipe_times_on_the_cpu():
    for nprog, nest in _atax_nests():
        for kind in ("vectorize", "einsum", "pallas_nest", "pallas_reduce"):
            t = psearch.measure_recipe(nprog, random_inputs(nprog), Recipe(kind=kind),
                                       repeats=1, device="cpu")
            assert np.isfinite(t) and t > 0, (fingerprint(nest), kind)


def test_measure_recipe_inf_on_refusal_and_non_finite_time(monkeypatch):
    nprog, _ = _atax_nests()[0]
    inputs = random_inputs(nprog)

    def refuse(*a, **k):
        raise TilingError("reduction without a parallel axis")

    with monkeypatch.context() as m:
        m.setattr(psearch, "compile_torch", refuse)
        assert psearch.measure_recipe(nprog, inputs, Recipe(kind="pallas_reduce"),
                                      device="cpu") == float("inf")
    for bad in (float("nan"), float("inf")):
        with monkeypatch.context() as m:
            m.setattr(psearch, "time_fn", lambda *a, **k: bad)
            assert psearch.measure_recipe(nprog, inputs, Recipe(kind="vectorize"),
                                          device="cpu") == float("inf")


def test_measure_recipe_reraises_a_kernel_error(monkeypatch):
    def broken(nk, env):
        raise RuntimeError("triton compile failed")

    def planned(nprog, recipe) -> bool:
        try:
            nest_kernel.plan_nest(nprog, nprog.body[0], psearch.schedule_from_recipe(recipe))
        except Unsupported:
            return False
        return True

    monkeypatch.setattr(nest_kernel, "run_nest", broken)
    launched = 0
    for nprog, _ in _atax_nests():
        for recipe in (Recipe(kind="pallas_nest"), Recipe(kind="pallas_reduce")):
            inputs = random_inputs(nprog)
            if planned(nprog, recipe):
                launched += 1
                with pytest.raises(RuntimeError, match="triton compile failed"):
                    psearch.measure_recipe(nprog, inputs, recipe, device="cpu")
            else:  # routed to torch by the planner: no launch, a finite time
                assert np.isfinite(psearch.measure_recipe(nprog, inputs, recipe, repeats=1,
                                                          device="cpu"))
    assert launched >= 2
