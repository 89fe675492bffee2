"""The port's online tuning half (``repro_torch.autotune``: the logit
program, ``SwapPolicy``, ``SearchSupervisor``, ``online_search_task``) and
``repro_torch.fault``'s degradation chain against the reference's, on the
CPU at small sizes.

The logit program is exact under every lowering (no multiply feeds an add),
so ``Y`` is compared bit for bit.  The supervisor's decisions are driven by
the same synthetic search results in both packages (as
tests/test_autotune.py drives the reference's), and the records and
database contents they leave must agree, the reference's ``xla`` /
``pallas_interpret`` backends standing for the port's ``torch`` / ``cuda``.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.autotune as RA
from repro.core import Daisy as RDaisy
from repro.core import TuningDatabase as RDatabase
from repro.core import fingerprint as r_fingerprint
from repro.core.embedding import embed_nest as r_embed
from repro.core.recipes import Recipe as RRecipe
from repro.fault import Fault as RFault
from repro.fault import FaultPlan as RFaultPlan
import repro_torch.autotune as PA
from repro_torch.core import Daisy, TuningDatabase, fingerprint
from repro_torch.core.codegen import compile_torch
from repro_torch.core.embedding import embed_nest
from repro_torch.core.recipes import Recipe
from repro_torch.core.search import schedule_from_recipe
from repro_torch.fault import (DegradedCompile, Fault, FaultInjected, FaultPlan,
                               compile_with_degradation, truncate_file)
from repro_torch.kernels import nest_kernel as p_nest

torch.set_num_threads(1)

# the port's backend for each of the reference's
BACKEND = {"xla": "torch", "pallas_interpret": "cuda"}


def _stale(pkg, prog, backend, measured_us=2500.0):
    """A deliberately mistuned database: every canonical nest of ``prog``
    pinned to ``sequential`` (tests/test_autotune.py's ``stale_database``)."""
    if pkg == "ref":
        d, db, rec, fp_fn, emb_fn = RDaisy(backend=backend), RDatabase(), RRecipe, \
            r_fingerprint, r_embed
    else:
        d, db, rec, fp_fn, emb_fn = Daisy(backend=backend, device="cpu"), TuningDatabase(), \
            Recipe, fingerprint, embed_nest
    p = d._normalized(prog)
    for nest in p.body:
        db.add(fp_fn(nest), emb_fn(p, nest), rec(kind="sequential", notes="stale"),
               provenance="stale-pretuned", measured_us=measured_us)
    db.meta["backend"] = backend
    return db


def _coords(prog):
    """(fingerprint, embedding) of the port's single canonical nest."""
    p = Daisy(backend="torch", device="cpu")._normalized(prog)
    assert len(p.body) == 1
    return fingerprint(p.body[0]), embed_nest(p, p.body[0])


def _operands(vocab, slots, seed=0):
    """Inputs that make every stage act: the floor and the cap each clip
    some lanes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"X": rng.normal(0, 3, (vocab, slots)).astype(f32),
            "B": rng.normal(0, 0.5, vocab).astype(f32),
            "S": rng.uniform(0.5, 1.5, vocab).astype(f32),
            "F": rng.normal(-1, 1, vocab).astype(f32),
            "C": rng.normal(0, 0.5, vocab).astype(f32),
            "G": rng.uniform(0.5, 1.5, vocab).astype(f32),
            "K": rng.normal(2, 1, vocab).astype(f32),
            "Y": np.zeros((vocab, slots), f32)}


# ---------------------------------------------------------------------------
# the logit program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,slots", [(32, 2), (512, 4), (32000, 8)])
def test_logit_program_fingerprint_and_embedding_match_reference(vocab, slots):
    """Written as ``Expr`` trees, the normalized program is one canonical
    nest with the reference's fingerprint and embedding, its six
    computations unchanged, so a reference database entry keys it."""
    rp = RDaisy()._normalized(RA.logit_pipeline_program(vocab, slots))
    pp = Daisy(device="cpu")._normalized(PA.logit_pipeline_program(vocab, slots))
    assert len(rp.body) == len(pp.body) == 1
    assert fingerprint(pp.body[0]) == r_fingerprint(rp.body[0])
    np.testing.assert_array_equal(embed_nest(pp, pp.body[0]), r_embed(rp, rp.body[0]))
    names = [c.name for c in pp.body[0].body[0].body]
    assert names == ["bias", "scale", "floor", "shift", "gain", "cap"]
    assert [(a.name, a.shape) for a in PA.logit_pipeline_program(vocab, slots).arrays] == \
        [(a.name, a.shape) for a in RA.logit_pipeline_program(vocab, slots).arrays]


@pytest.mark.parametrize("kind", ["sequential", "vectorize", "einsum", "pallas_nest"])
@pytest.mark.parametrize("vocab,slots", [(32, 2), (512, 4)])
def test_logit_program_output_bit_identical_to_reference(kind, vocab, slots):
    """``Y`` under each recipe (``pallas_nest``: K2's plain version, on the
    CPU) equals the reference's ``Daisy(backend="xla")`` output bit for
    bit (tolerance 0)."""
    inputs = _operands(vocab, slots)
    rfn, _ = RDaisy(backend="xla").compile(RA.logit_pipeline_program(vocab, slots))
    want = np.asarray(rfn(inputs)["Y"])
    prog = PA.logit_pipeline_program(vocab, slots)
    fp, emb = _coords(prog)
    db = TuningDatabase()
    db.add(fp, emb, Recipe(kind=kind))
    d = Daisy(db=db, backend="cuda", device="cpu")
    fn, plan = d.compile(prog)
    assert [n.recipe.kind for n in plan.nests] == [kind]
    before = p_nest.PLAIN["pallas_nest"]
    got = fn(inputs)["Y"].numpy()
    assert p_nest.PLAIN["pallas_nest"] - before == (kind == "pallas_nest")
    np.testing.assert_array_equal(got, want)
    # every stage acted: some lanes were floored, some capped
    t2 = (inputs["X"] + inputs["B"][:, None]) * inputs["S"][:, None]
    assert (t2 < inputs["F"][:, None]).any() and (got == inputs["K"][:, None]).any()


def test_logit_nest_takes_the_flattened_form():
    """The logit nest is pointwise over (V, N) with six vectors over V: K2's
    flattened form reads each vector at the flat offset divided by N, so the
    unmasked body loads X and the six vectors once and stores T1-T5 and Y
    once (the bytes of the bound); contiguous arrays take it at launch."""
    prog = PA.logit_pipeline_program(64, 4)
    p = Daisy(device="cpu")._normalized(prog)
    nk = p_nest.plan_nest(p, p.body[0], schedule_from_recipe(Recipe(kind="pallas_nest")))
    assert nk.flat and sorted(nk.group_elems) == [64, 256]
    src = nk.source
    flat = src[src.index("if FLAT:"):src.index("        else:\n            fm")]
    assert flat.count("tl.load(") == 7 and flat.count("tl.store(") == 6
    assert "q1 = offs // (n" in flat and flat.count("+ q1)") == 6
    env = {name: torch.zeros(p.array(name).shape) for name in nk.arrays}
    assert p_nest.launch_args(nk, env)[2]
    env["X"] = torch.zeros(4, 64).T
    with pytest.raises(ValueError, match="parameter group"):
        p_nest.launch_args(nk, env)


def test_compile_torch_makes_a_transposed_input_contiguous():
    """The engine feeds ``X = logits.T``: the program's copy of it is
    contiguous (the layout K2's launch requires of a shape group) and holds
    the same values, and the launch then takes the flattened form."""
    prog = PA.logit_pipeline_program(32, 2)
    p = Daisy(device="cpu")._normalized(prog)
    sched = schedule_from_recipe(Recipe(kind="pallas_nest"))
    nk = p_nest.plan_nest(p, p.body[0], sched)
    inputs = {k: torch.as_tensor(v) for k, v in _operands(32, 2).items()}
    xt = inputs["X"].T.contiguous().T  # (32, 2) with strides (1, 32)
    assert not xt.is_contiguous()
    fn = compile_torch(p, sched, device="cpu")
    env = fn(dict(inputs, X=xt))
    assert env["X"].is_contiguous() and torch.equal(env["X"], inputs["X"])
    assert p_nest.launch_args(nk, env)[2]
    torch.testing.assert_close(env["Y"], fn(inputs)["Y"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# swap policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cand,inc,margin", [(89.0, 100.0, 0.1), (95.0, 100.0, 0.1),
                                             (100.0, 100.0, 0.1), (float("inf"), 100.0, 0.1),
                                             (float("nan"), 100.0, 0.1),
                                             (100.0, float("inf"), 0.1), (49.0, 100.0, 1.0)])
def test_swap_policy_accepts_like_the_reference(cand, inc, margin):
    assert PA.SwapPolicy(margin=margin).accepts(cand, inc) == \
        RA.SwapPolicy(margin=margin).accepts(cand, inc)


def test_swap_policy_chain():
    assert PA.SwapPolicy().chain_for("torch") == ("torch",)
    assert PA.SwapPolicy().chain_for("cuda") == ("cuda", "torch")
    assert PA.SwapPolicy(validate_backends=("torch",)).chain_for("cuda") == ("torch",)


# ---------------------------------------------------------------------------
# the supervisor's decisions, on the reference's synthetic results
# ---------------------------------------------------------------------------

def _fake(fp, emb, cand, cand_us, inc, inc_us, key):
    return {"fingerprint": fp, "embedding": np.asarray(emb).tolist(),
            "recipe": cand.to_json(), "measured_us": cand_us,
            "provenance": "online:test", "incumbent": inc.to_json(),
            "incumbent_us": inc_us, "name": "logit_pipeline", "nest_index": 0,
            "program_key": key}


def _scenario(pkg, name, tmp_path):
    """Run one of tests/test_autotune.py's supervisor scenarios in ``pkg``;
    returns what it left: swaps, rejection reasons, quarantined nests, the
    engine's degradations, generation steps, the database's entries and the
    fold-back reports and file."""
    A = RA if pkg == "ref" else PA
    R = RRecipe if pkg == "ref" else Recipe
    plan_cls, fault_cls = (RFaultPlan, RFault) if pkg == "ref" else (FaultPlan, Fault)
    backend = "pallas_interpret" if name == "degraded" else "xla"
    if pkg == "port":
        backend = BACKEND[backend]
    prog = A.logit_pipeline_program(vocab=32, slots=2)
    db = _stale(pkg, prog, backend)
    fp, emb = _coords(PA.logit_pipeline_program(32, 2))
    inc = db.lookup_exact(fp)
    kw = dict(mode="sync", backend=backend, policy=A.SwapPolicy(margin=0.05))
    if pkg == "port":
        kw["device"] = "cpu"
    if name == "margin":
        kw["policy"] = A.SwapPolicy(margin=0.1)
    if name == "validation":
        kw["fault_plan"] = plan_cls([fault_cls("daisy.compile", "error", key=backend, times=-1)])
    if name == "degraded":
        kw["fault_plan"] = plan_cls([fault_cls("daisy.compile", "error", key=backend)])
    if name in ("rollback", "healthy"):
        kw["policy"] = A.SwapPolicy(margin=0.05, rollback_ratio=1.5, rollback_window=3)
    sup = A.SearchSupervisor(db, **kw)
    key = sup.register(prog)
    engine = SimpleNamespace(degradations=[])
    gens = [db.generation]
    if name in ("rollback", "healthy"):
        for _ in range(4):
            sup.telemetry.observe(key, 0.001)
    cand_us = 990.0 if name == "margin" else 100.0
    sup._results.put(_fake(fp, emb, R(kind="vectorize"), cand_us, inc, 1000.0, key))
    polls = [len(sup.poll(engine=engine))]
    gens.append(db.generation)
    if name in ("rollback", "healthy"):
        for _ in range(3):
            sup.telemetry.observe(key, 0.01 if name == "rollback" else 0.0005)
        polls.append(len(sup.poll(engine=engine)))
        gens.append(db.generation)
    out = {
        "polls": polls,
        "generation_steps": [b - a for a, b in zip(gens, gens[1:])],
        "swaps": [(s.program, s.fingerprint, s.old_recipe.kind, s.new_recipe.kind,
                   s.candidate_us, s.incumbent_us, s.degraded_to, s.rolled_back)
                  for s in sup.swaps],
        "rejected": [(r["reason"].split(":")[0], r["candidate_us"], r["incumbent_us"])
                     for r in sup.rejected],
        "quarantined": sorted(sup.quarantined),
        "degradations": engine.degradations,
        "entries": [(e.fingerprint, e.recipe.kind, e.measured_us, e.provenance)
                    for e in db.entries],
    }
    if name == "fold_back":
        fleet = tmp_path / f"{pkg}.json"
        out["reports"] = [sup.fold_back(fleet), sup.fold_back(fleet)]
        disk = (RDatabase if pkg == "ref" else TuningDatabase).load(fleet)
        out["disk"] = ([(e.fingerprint, e.recipe.kind, e.measured_us) for e in disk.entries],
                       disk.meta["online_swaps"])
    return out


@pytest.mark.parametrize("name", ["swap", "margin", "validation", "degraded", "rollback",
                                  "healthy", "fold_back"])
def test_supervisor_decisions_match_reference(name, tmp_path):
    """Swap and generation bump, margin rejection, validation rejection, a
    degraded candidate recorded on the engine, rollback with quarantine, a
    healthy watch disarmed, fold-back counts: the port ends with the
    reference's records and database contents."""
    ref, port = _scenario("ref", name, tmp_path), _scenario("port", name, tmp_path)
    ref["degradations"] = [(p, BACKEND[a], BACKEND[b]) for p, a, b in ref["degradations"]]
    ref["swaps"] = [s[:6] + (BACKEND.get(s[6]), s[7]) for s in ref["swaps"]]
    assert port == ref
    swapped = name not in ("margin", "validation")
    assert port["polls"][0] == swapped and bool(port["generation_steps"][0]) == swapped
    if name == "degraded":
        assert port["degradations"] == [("logit_pipeline", "cuda", "torch")]
    if name == "rollback":
        assert port["swaps"][0][-1] and port["quarantined"] and port["generation_steps"][1]
        assert port["entries"][0][1] == "sequential"
    if name == "healthy":
        assert not port["swaps"][0][-1] and not port["quarantined"]
        assert port["entries"][0][1] == "vectorize"
    if name == "fold_back":
        assert port["reports"][0]["added"] == 1 and port["reports"][1]["added"] == 0
        assert port["disk"][1] == 2  # each fold-back counts the swap


# ---------------------------------------------------------------------------
# the online search worker
# ---------------------------------------------------------------------------

def _task(prog, fp, **kw):
    t = {"name": prog.name, "nest_index": 0, "backend": "torch", "device": "cpu",
         "fingerprint": fp, "iterations": 1, "population": 2, "repeats": 1,
         "program_key": "k", "program": prog}
    t.update(kw)
    return t


def test_online_search_task_reports_incumbent_and_candidate():
    """The stale ``sequential`` incumbent (a Python loop over the vocabulary
    on the CPU) is measured, and the one-iteration search beats it."""
    prog = PA.logit_pipeline_program(64, 2)
    db = _stale("port", prog, "torch")
    fp, _ = _coords(prog)
    results, quarantined = PA.run_supervised(
        [_task(prog, fp, deadline_s=30.0, incumbent=db.lookup_exact(fp).to_json())],
        jobs=1, verbose=False, worker=PA.online_search_task)
    assert not quarantined and len(results) == 1
    r = results[0]
    assert r["fingerprint"] == fp and r["program_key"] == "k"
    assert r["incumbent"]["kind"] == "sequential" and math.isfinite(r["incumbent_us"])
    assert r["measured_us"] < r["incumbent_us"] and r["measurements"] >= 2


def test_online_search_under_cuda_also_measures_the_nest_kernel():
    """Under the ``cuda`` backend the nest kernel of the nest's class is
    measured beside the search's winner (its plain version on the CPU);
    under ``torch`` there is none, as the reference's search has none."""
    prog = PA.logit_pipeline_program(64, 2)
    fp, _ = _coords(prog)
    [r] = PA.run_supervised([_task(prog, fp, backend="cuda", incumbent=None)], jobs=1,
                            verbose=False, worker=PA.online_search_task)[0]
    assert math.isfinite(r["kernel_us"]) and r["measured_us"] <= r["kernel_us"]
    assert (r["recipe"]["kind"] == "pallas_nest") == r["provenance"].endswith(":kernel")
    nprog = Daisy(device="cpu")._normalized(prog)
    assert PA.kernel_candidate(nprog, "cuda") == Recipe(kind="pallas_nest")
    assert PA.kernel_candidate(nprog, "torch") is None
    from repro_torch.polybench import BENCHMARKS

    atax = Daisy(device="cpu")._normalized(BENCHMARKS["atax"].make("a", "mini"))
    kinds = set()
    for nest in atax.body:
        from repro_torch.core.scheduler import nest_program

        k = PA.kernel_candidate(nest_program(atax, nest), "cuda")
        kinds.add(k.kind if k else None)
    assert "pallas_reduce" in kinds


def test_poison_online_search_is_quarantined_not_raised():
    prog = PA.logit_pipeline_program(32, 2)
    fp, _ = _coords(prog)
    plan = FaultPlan([Fault("tune.worker", "error", key=fp, times=-1)])
    results, quarantined = PA.run_supervised(
        [_task(prog, fp, incumbent=None)], jobs=1, verbose=False, max_task_retries=1,
        fault_plan=plan, worker=PA.online_search_task)
    assert results == [] and fp in quarantined and plan.count("tune.worker") == 2


def test_supervisor_survives_poison_round():
    prog = PA.logit_pipeline_program(32, 2)
    db = _stale("port", prog, "torch")
    fp, _ = _coords(prog)
    plan = FaultPlan([Fault("tune.worker", "error", key=fp, times=-1)])
    sup = PA.SearchSupervisor(db, backend="torch", mode="sync", fault_plan=plan,
                              max_task_retries=1, policy=PA.SwapPolicy(min_observations=1),
                              device="cpu")
    key = sup.register(prog)
    sup.telemetry.observe(key, 0.01)
    assert sup.maybe_launch() == 1
    sup.poll()
    assert fp in sup.quarantined and not sup.swaps
    assert sup.maybe_launch() == 0  # quarantined nests are never re-launched


def test_seed_nest_threads_deadline():
    """An expired deadline cuts a 50 x 8 search to the seed's measurement."""
    prog = PA.logit_pipeline_program(32, 2)
    d = Daisy(backend="torch", device="cpu")
    p = d._normalized(prog)
    _fp, _emb, recipe, t, _prov = d.seed_nest(p, p.body[0], search=True, search_iterations=50,
                                              population=8, repeats=1, deadline_s=0.0)
    assert math.isfinite(t) and recipe is not None


# ---------------------------------------------------------------------------
# registry and modes
# ---------------------------------------------------------------------------

def test_build_program_import_coordinates():
    p = PA.build_program("import", "repro_torch.autotune:logit_pipeline_program",
                         kwargs={"vocab": 32, "slots": 2})
    assert p.name == "logit_pipeline" and dict((a.name, a.shape) for a in p.arrays)["X"] == (32, 2)
    with pytest.raises(ValueError, match="module:function"):
        PA.build_program("import", "no-colon-here")


def test_spawn_registration_requires_builder():
    prog = PA.logit_pipeline_program(32, 2)
    sup = PA.SearchSupervisor(_stale("port", prog, "torch"), backend="torch", mode="spawn",
                              device="cpu")
    with pytest.raises(ValueError, match="builder"):
        sup.register(prog)
    key = sup.register(prog, builder={"source": "import",
                                      "name": "repro_torch.autotune:logit_pipeline_program",
                                      "builder_kwargs": {"vocab": 32, "slots": 2}})
    [task] = sup._registered[key].tasks
    assert "program" not in task and PA._task_program(task).name == "logit_pipeline"


def test_spawn_jobs_above_one_on_cuda_refused_before_the_card():
    prog = PA.logit_pipeline_program(32, 2)
    with pytest.raises(ValueError, match="jobs=2"):
        PA.SearchSupervisor(_stale("port", prog, "torch"), mode="spawn", jobs=2, device="cuda")
    with pytest.raises(ValueError, match="sync|thread|spawn"):
        PA.SearchSupervisor(_stale("port", prog, "torch"), mode="fork", device="cpu")


# ---------------------------------------------------------------------------
# the degradation chain
# ---------------------------------------------------------------------------

def test_compile_with_degradation_first_rung():
    res = compile_with_degradation(PA.logit_pipeline_program(32, 2), device="cpu")
    assert isinstance(res, DegradedCompile) and res.backend == "cuda" and not res.degraded
    assert [n.recipe.kind for n in res.plan.nests] == ["vectorize"]


def test_compile_with_degradation_degrades_on_an_injected_failure():
    plan = FaultPlan([Fault("daisy.compile", "error", key="cuda")])
    res = compile_with_degradation(PA.logit_pipeline_program(32, 2), fault_plan=plan,
                                   device="cpu")
    assert res.backend == "torch" and res.degraded
    assert [(b, type(e)) for b, e in res.errors] == [("cuda", FaultInjected)]
    out = res.fn(_operands(32, 2))["Y"]
    assert out.shape == (32, 2) and bool(torch.isfinite(out).all())


def test_compile_with_degradation_raises_when_every_rung_fails():
    plan = FaultPlan([Fault("daisy.compile", "error", times=-1)])
    with pytest.raises(RuntimeError, match="all backends failed") as info:
        compile_with_degradation(PA.logit_pipeline_program(32, 2), fault_plan=plan,
                                 device="cpu")
    assert isinstance(info.value.__cause__, FaultInjected)
    assert plan.fired == [("daisy.compile", "cuda", "error"), ("daisy.compile", "torch", "error")]
    # a mesh now goes to every rung's Daisy, which refuses one without the
    # shard axis: every rung fails
    with pytest.raises(RuntimeError, match="all backends failed") as info:
        compile_with_degradation(PA.logit_pipeline_program(32, 2), mesh=object(), device="cpu")
    assert isinstance(info.value.__cause__, ValueError)


def test_truncate_file(tmp_path):
    f = tmp_path / "db.json"
    f.write_bytes(b"0123456789")
    truncate_file(f, 0.3)
    assert f.read_bytes() == b"012"
