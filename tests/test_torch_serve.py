"""The port's serving engine (``repro_torch.serve``) against the reference's
``repro.serve.ServingEngine`` at reduced size, in fp32 on the CPU.

fp32 at reduced size is deterministic enough for greedy tokens to agree
token for token, so the engines are compared on tokens; prompts are
tests/test_serve.py's.
"""
import warnings
from concurrent.futures import CancelledError

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServingEngine as RServingEngine
from repro.serve import prefill_buckets as r_buckets
from repro_torch.configs import get_config as p_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (NonFiniteLogits, RequestHandle, RequestState, ServeConfig,
                               ServingEngine, prefill_buckets)

torch.set_num_threads(1)

PROMPTS = [np.array([3, 1, 4, 1, 5], np.int32),
           np.array([9, 8, 7], np.int32),
           np.array([2, 2, 2, 2, 2, 2, 2], np.int32),
           np.array([6], np.int32),
           np.array([1, 2, 3, 4], np.int32)]  # > batch_slots


def _models(arch):
    rcfg, pcfg = r_config(arch).reduced(), p_config(arch).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, rparams, pcfg, pparams


@pytest.fixture(scope="module")
def setup():
    return _models("minicpm-2b")


def _serve(engine_cls, config_cls, cfg, params, prompts, **scfg):
    eng = engine_cls(cfg, params, config_cls(**scfg))
    hs = [eng.submit(p) for p in prompts]
    eng.drain()
    return [h.tokens for h in hs]


def test_greedy_matches_reference_engine(setup):
    rcfg, rparams, pcfg, pparams = setup
    kw = dict(batch_slots=4, max_len=64, max_new_tokens=6)
    want = _serve(RServingEngine, RServeConfig, rcfg, rparams, PROMPTS, **kw)
    assert _serve(ServingEngine, ServeConfig, pcfg, pparams, PROMPTS, **kw) == want


def test_greedy_matches_reference_engine_past_the_window():
    """Danube (reduced window 64) on a 160-position cache: prompts cross
    several buckets and decoding runs past the window, where the cache path
    ignores it in both engines (repro/models/layers.py:167)."""
    rcfg, rparams, pcfg, pparams = _models("h2o-danube-3-4b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32) for n in (5, 40, 70, 100)]
    kw = dict(batch_slots=2, max_len=160, max_new_tokens=40)
    want = _serve(RServingEngine, RServeConfig, rcfg, rparams, prompts, **kw)
    assert _serve(ServingEngine, ServeConfig, pcfg, pparams, prompts, **kw) == want


def test_greedy_matches_reference_engine_moe():
    """Mixtral's MoE decoder: prefill dispatches the padded bucket with its
    capacity, the batched decode drops nothing, as the reference's per-slot
    decode never does; prompts cross buckets and slots refill."""
    rcfg, rparams, pcfg, pparams = _models("mixtral-8x7b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32) for n in (5, 40, 17, 70, 9)]
    kw = dict(batch_slots=3, max_len=128, max_new_tokens=8)
    want = _serve(RServingEngine, RServeConfig, rcfg, rparams, prompts, **kw)
    assert _serve(ServingEngine, ServeConfig, pcfg, pparams, prompts, **kw) == want


def test_pipeline_depth_invariant(setup):
    _, _, pcfg, pparams = setup
    outs = [_serve(ServingEngine, ServeConfig, pcfg, pparams, PROMPTS[:3], batch_slots=2,
                   max_len=64, max_new_tokens=5, pipeline_depth=depth) for depth in (0, 1, 3)]
    assert outs[0] == outs[1] == outs[2]


def test_eos_slot_refill_mid_stream(setup):
    """eos in one slot while the other continues: the finished slot is
    refilled from the queue and nobody else's tokens change."""
    rcfg, rparams, pcfg, pparams = setup
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9, 8, 7], np.int32),
               np.array([2, 7, 1, 8], np.int32)]
    refs = _serve(RServingEngine, RServeConfig, rcfg, rparams, prompts, batch_slots=1,
                  max_len=64, max_new_tokens=8)
    eos = refs[0][3]
    assert eos not in refs[1] and eos not in refs[2], "test prompt collision"
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=2, max_len=64,
                                                   max_new_tokens=8, eos_id=eos))
    hs = [eng.submit(p) for p in prompts]
    out = eng.drain()
    assert hs[0].tokens == refs[0][:4]
    assert hs[1].tokens == refs[1]
    assert hs[2].tokens == refs[2]
    assert set(out) == {h.rid for h in hs}


def test_handle_lifecycle_and_streaming(setup):
    _, _, pcfg, pparams = setup
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4))
    seen = []
    h = eng.submit(np.array([5, 6, 7], np.int32), on_token=lambda hh, t: seen.append((hh.rid, t)))
    assert isinstance(h, RequestHandle) and h.state is RequestState.QUEUED and not h.done
    h2 = eng.submit(np.array([1, 2], np.int32))
    assert eng.step() == 2 and h.state is RequestState.RUNNING
    assert h.result() == [t for _, t in seen] and len(h.tokens) == 4
    assert h.state is RequestState.COMPLETED
    out = eng.drain()
    assert out == {h.rid: h.tokens, h2.rid: h2.tokens} and h.rid != h2.rid
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(np.array([1], np.int32))


def test_legacy_submit_and_run_deprecated(setup):
    _, _, pcfg, pparams = setup
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=5))
    with pytest.warns(DeprecationWarning):
        eng.submit(0, np.array([1, 2, 3], np.int32))
    eng.submit(np.array([9, 8, 7, 6], np.int32), rid=1)
    eng.submit(np.array([4, 4], np.int32), rid=2)
    with pytest.warns(DeprecationWarning):
        out = eng.run()
    assert set(out) == {0, 1, 2} and all(len(v) == 5 for v in out.values())


def test_temperature_sampling_is_seeded(setup):
    _, _, pcfg, pparams = setup
    outs = [_serve(ServingEngine, ServeConfig, pcfg, pparams, PROMPTS[:3], batch_slots=2,
                   max_len=64, max_new_tokens=4, temperature=1.0, seed=7) for _ in range(2)]
    assert outs[0] == outs[1] and all(len(t) == 4 for t in outs[0])


@pytest.mark.parametrize("max_len,min_bucket", [(64, 16), (512, 16), (100, 8), (16, 16)])
def test_prefill_buckets_match_reference(max_len, min_bucket):
    assert prefill_buckets(max_len, min_bucket) == r_buckets(max_len, min_bucket)


def test_submit_rejects_bad_prompts(setup):
    _, _, pcfg, pparams = setup
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=8))
    for bad in (np.zeros((0,), np.int32), np.zeros((2, 2), np.int32),
                np.zeros((40,), np.int32), np.zeros((30,), np.int32)):
        with pytest.raises(ValueError):
            eng.submit(bad)
    eng.submit(np.array([1], np.int32), rid=5)
    with pytest.raises(ValueError, match="in flight"):
        eng.submit(np.array([2], np.int32), rid=5)


class _Ranks:
    """The axis sizes of a mesh of two ranks, with no world."""
    shape, axis_names = {"data": 1, "model": 2}, ("data", "model")


# what is not ported of each option: under a mesh of ranks, the tuner
NOT_PORTED = {"mesh": dict(mesh=_Ranks(), tuner=object())}


@pytest.mark.parametrize("option", ["mesh"])
def test_options_not_ported_are_refused(setup, option):
    _, _, pcfg, pparams = setup
    with pytest.raises(NotImplementedError, match=option):
        ServingEngine(pcfg, pparams, ServeConfig(), **NOT_PORTED[option])


def test_non_finite_logits_fail_only_that_request():
    # Danube: its lm_head is untied, so a NaN embedding row poisons only the
    # requests that hold that token
    rcfg, rparams, pcfg, pparams = _models("h2o-danube-3-4b")
    poisoned = dict(pparams, embed=pparams["embed"].clone())
    poisoned["embed"][13] = float("nan")
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([13, 2], np.int32),
               np.array([9, 8, 7], np.int32)]
    eng = ServingEngine(pcfg, poisoned, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4))
    hs = [eng.submit(p) for p in prompts]
    out = eng.drain()
    assert hs[1].failed and isinstance(hs[1].error, NonFiniteLogits)
    with pytest.raises(NonFiniteLogits):
        hs[1].result()
    want = _serve(RServingEngine, RServeConfig, rcfg, rparams, [prompts[0], prompts[2]],
                  batch_slots=2, max_len=64, max_new_tokens=4)
    assert [hs[0].tokens, hs[2].tokens] == want and set(out) == {hs[0].rid, hs[2].rid}


def test_timeout_and_cancel(setup):
    _, _, pcfg, pparams = setup
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=6))
    running = eng.submit(np.array([1, 2, 3], np.int32))
    queued = eng.submit(np.array([4, 5], np.int32))
    late = eng.submit(np.array([6], np.int32), timeout_s=0.0)
    eng.step()
    assert running.state is RequestState.RUNNING and late.state is RequestState.TIMED_OUT
    with pytest.raises(TimeoutError):
        late.result()
    assert queued.cancel() and queued.state is RequestState.CANCELLED
    assert not queued.cancel()
    with pytest.raises(CancelledError):
        queued.result()
    assert running.cancel()
    assert eng.step() == 0 and running.tokens  # kept its partial tokens
    fresh = eng.submit(np.array([7, 7], np.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(fresh.result()) == 6


def test_shutdown_cancels_everything(setup):
    _, _, pcfg, pparams = setup
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=6))
    hs = [eng.submit(p) for p in PROMPTS[:2]]
    eng.step()
    eng.shutdown()
    assert all(h.state is RequestState.CANCELLED for h in hs)
    with pytest.raises(RuntimeError):
        eng.submit(PROMPTS[0])
