"""The port's serving engine with a logit program, an online tuner and
injected faults (``repro_torch.serve``) against the reference's
``repro.serve.ServingEngine``, on the reduced MiniCPM config in fp32 on the
CPU, with the reference's weights carried across.

As in tests/test_torch_serve.py, greedy tokens are compared token for token
(exact); the logit program is exact under every lowering, so its recipe
never changes a token.  The traffic and operands are
tests/test_autotune.py's ``TestOnlineEndToEnd``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.autotune import logit_pipeline_program as r_program
from repro.configs import get_config as r_config
from repro.core import TuningDatabase as RDatabase
from repro.fault import Fault as RFault
from repro.fault import FaultPlan as RFaultPlan
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServingEngine as RServingEngine
from repro_torch.autotune import SearchSupervisor, SwapPolicy, logit_pipeline_program
from repro_torch.configs import get_config as p_config
from repro_torch.core import Recipe, TuningDatabase
from repro_torch.core.cache import jit_cache
from repro_torch.fault import Fault, FaultPlan
from repro_torch.kernels import nest_kernel as p_nest
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import NonFiniteLogits, ServeConfig, ServingEngine
from test_torch_online import _stale

torch.set_num_threads(1)

SLOTS, MAX_LEN, NEW = 2, 64, 6


@pytest.fixture(scope="module")
def setup():
    rcfg, pcfg = r_config("minicpm-2b").reduced(), p_config("minicpm-2b").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(7)
    v = rcfg.vocab
    aux = {"B": rng.normal(0, 0.5, v).astype(np.float32),
           "S": np.full(v, 1.1, np.float32), "G": np.full(v, 0.9, np.float32),
           "F": np.full(v, -1e9, np.float32), "K": np.full(v, 1e9, np.float32)}
    prompts = [rng.integers(1, v, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 9, size=6)]
    return rcfg, rparams, pcfg, pparams, aux, prompts


def _serve(engine):
    hs = [engine.submit(p) for p in engine._prompts]
    engine.drain()
    return hs


def _ref_engine(setup, **kw):
    rcfg, rparams, _, _, aux, prompts = setup
    scfg = RServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=NEW,
                        temperature=kw.pop("temperature", 0.0))
    eng = RServingEngine(rcfg, rparams, scfg, logit_program=r_program(rcfg.vocab, SLOTS),
                         logit_inputs=aux, **kw)
    eng._prompts = prompts
    return eng


def _port_engine(setup, **kw):
    _, _, pcfg, pparams, aux, prompts = setup
    scfg = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=NEW,
                       temperature=kw.pop("temperature", 0.0))
    eng = ServingEngine(pcfg, pparams, scfg,
                        logit_program=kw.pop("program", logit_pipeline_program(pcfg.vocab, SLOTS)),
                        logit_inputs=kw.pop("aux", aux), **kw)
    eng._prompts = prompts
    return eng


def test_sync_tuner_swaps_and_keeps_the_reference_tokens(setup):
    """A stale ``sequential`` database, a sync tuner on the port's default
    backend (``cuda``; its kernels' plain versions on the CPU): telemetry
    launches a search after 4 steps, a validated swap lands, and the tokens
    equal the reference engine's over the same stale database, token for
    token."""
    rcfg = setup[0]
    want = [h.tokens for h in _serve(_ref_engine(
        setup, tuning_db=_stale("ref", r_program(rcfg.vocab, SLOTS), "xla")))]
    prog = logit_pipeline_program(rcfg.vocab, SLOTS)
    sup = SearchSupervisor(_stale("port", prog, "cuda"), mode="sync", check_every=4,
                           iterations=1, population=2, repeats=1, deadline_s=30.0,
                           policy=SwapPolicy(margin=0.05, min_observations=2), device="cpu")
    eng = _port_engine(setup, program=prog, tuner=sup)
    got = [h.tokens for h in _serve(eng)]
    assert len(sup.swaps) >= 1, f"no swap landed (rejected: {sup.rejected})"
    assert sup.db.lookup_exact(sup.swaps[0].fingerprint).kind != "sequential"
    assert got == want
    assert eng.telemetry.count(eng._telemetry_key) > 0 and not eng.degradations
    assert len({t for ts in got for t in ts}) > 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_program_backends_give_the_reference_tokens(setup, backend):
    """The program on the default recipe (no tuner, a private database),
    under either backend, against the reference engine with its program."""
    want = [h.tokens for h in _serve(_ref_engine(setup, tuning_db=RDatabase()))]
    eng = _port_engine(setup, tuning_db=TuningDatabase(), program_backend=backend)
    assert [h.tokens for h in _serve(eng)] == want


def test_thread_tuner_ends_and_keeps_the_tokens(setup):
    """The same loop with the searches on a daemon thread (from a stale
    ``vectorize`` entry, so the steps stay cheap): the thread ends without
    error, nothing is quarantined, and the tokens are the reference
    engine's over its default recipe."""
    rcfg = setup[0]
    want = [h.tokens for h in _serve(_ref_engine(setup, tuning_db=RDatabase()))]
    prog = logit_pipeline_program(rcfg.vocab, SLOTS)
    db = TuningDatabase()
    stale = _stale("port", prog, "cuda")
    db.add(stale.entries[0].fingerprint, stale.entries[0].embedding, Recipe(kind="vectorize"))
    sup = SearchSupervisor(db, mode="thread", check_every=2, iterations=1, population=2,
                           repeats=1, deadline_s=30.0,
                           policy=SwapPolicy(margin=0.05, min_observations=2), device="cpu")
    eng = _port_engine(setup, program=prog, tuner=sup)
    got = [h.tokens for h in _serve(eng)]
    if sup._thread is not None:  # the last round, unless a later check cleared it
        sup._thread.join(timeout=60)
    assert not sup.busy
    sup.poll(engine=eng)
    assert got == want and not sup.quarantined and not eng.degradations
    assert sup._searched == {stale.entries[0].fingerprint}


def test_swap_resolves_a_new_program_and_rollback_is_a_cache_hit(setup):
    """A commit (a new generation) resolves the program under the new
    recipe at the next step (``pallas_nest``: K2's plain version, once a
    decode step); restoring the old recipe (another generation) is served
    from the cache, keyed by the recipes the generation resolves."""
    rcfg = setup[0]
    prog = logit_pipeline_program(rcfg.vocab, SLOTS)
    db = _stale("port", prog, "cuda")
    eng = _port_engine(setup, program=prog, tuning_db=db)
    fp, first = db.entries[0].fingerprint, eng._dispatch_greedy
    prev = db.replace_entry(fp, Recipe(kind="pallas_nest"))
    before = p_nest.PLAIN["pallas_nest"]
    h = eng.submit(setup[5][0])
    eng.drain()
    assert eng._dispatch_greedy is not first and len(h.tokens) == NEW
    # one run a decode step (with the pipelined overshoot the harvest drops)
    assert p_nest.PLAIN["pallas_nest"] - before >= NEW - 1
    size, hits = len(jit_cache._entries), jit_cache.stats.hits
    db.replace_entry(fp, *prev)  # the rollback
    eng._resolve_step_fns()
    assert eng._prog_gen == db.generation and jit_cache.stats.hits == hits + 1
    assert len(jit_cache._entries) == size


@pytest.mark.parametrize("case", ["tuner db", "unknown input", "program shape"])
def test_bad_program_setups_rejected(setup, case):
    rcfg = setup[0]
    prog = logit_pipeline_program(rcfg.vocab, SLOTS)
    if case == "tuner db":
        sup = SearchSupervisor(_stale("port", prog, "cuda"), mode="sync", device="cpu")
        with pytest.raises(ValueError, match="tuner.db"):
            _port_engine(setup, tuning_db=TuningDatabase(), tuner=sup)
    elif case == "unknown input":
        with pytest.raises(ValueError, match="TYPO"):
            _port_engine(setup, aux=dict(setup[4], TYPO=np.zeros(rcfg.vocab, np.float32)))
    else:
        with pytest.raises(ValueError, match="batch_slots"):
            _port_engine(setup, program=logit_pipeline_program(rcfg.vocab, SLOTS + 1))


def _plans(pkg, sync):
    """One fault schedule for both packages: a NaN at one request's
    prefill, an error at another's decode (and on the sync path at a
    third's logits), and seeded ``serve.step`` errors."""
    F, P = (RFault, RFaultPlan) if pkg == "ref" else (Fault, FaultPlan)
    faults = [F("serve.prefill", "nan", key=1), F("serve.decode", "error", key=3)]
    if sync:
        faults.append(F("serve.logits", "error", key=4))
    return P(faults, seed=7, rate=0.05, sites=("serve.step",))


@pytest.mark.parametrize("sync", [False, True], ids=["greedy", "sync"])
def test_fault_plan_fails_the_reference_requests(setup, sync):
    """Under one seeded plan, the port fails the reference's requests and
    its survivors generate the reference's tokens.  The sync path samples
    on the host at temperature 1e-5, where every token but the largest has
    probability 0, so it is greedy and no draw depends on which requests
    failed."""
    t = 1e-5 if sync else 0.0
    ref_plan, port_plan = _plans("ref", sync), _plans("port", sync)
    ref = _serve(_ref_engine(setup, fault_plan=ref_plan, temperature=t))
    port = _serve(_port_engine(setup, fault_plan=port_plan, temperature=t,
                               tuning_db=TuningDatabase()))
    assert port_plan.fired == ref_plan.fired and port_plan.count("serve.step") >= 1
    assert [h.state.value for h in port] == [h.state.value for h in ref]
    sites = {site for site, _, _ in port_plan.fired}
    assert sites == {"serve.prefill", "serve.decode", "serve.step"} | (
        {"serve.logits"} if sync else set())
    assert isinstance(port[1].error, NonFiniteLogits)
    survivors = [i for i, h in enumerate(port) if not h.failed]
    assert survivors and [port[i].tokens for i in survivors] == [ref[i].tokens for i in survivors]


def test_compile_resilient_records_its_degradation(setup):
    prog = logit_pipeline_program(32, 2)
    eng = _port_engine(setup, tuning_db=TuningDatabase(),
                       fault_plan=FaultPlan([Fault("daisy.compile", "error", key="cuda")]))
    res = eng.compile_resilient(prog)
    assert res.backend == "torch" and res.degraded
    assert eng.degradations == [("logit_pipeline", "cuda", "torch")]
    again = eng.compile_resilient(prog)  # the fault burnt out: the first rung holds
    assert again.backend == "cuda" and len(eng.degradations) == 1
