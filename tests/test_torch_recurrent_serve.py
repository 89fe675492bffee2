"""The port's serving engine on the recurrent families (``hybrid``: Jamba;
``ssm``: xLSTM with mLSTM and sLSTM layers) against the reference's
``repro.serve.ServingEngine`` at reduced size, in fp32 on the CPU: exact-length
prefill, per-layer slot states, refills.

The xLSTM model is tests/test_torch_ssm.py's (pattern ``("m", "s")``); its
reference engine runs with decode states built as ``_empty_state`` builds
them (see that file: the reference's own start both stabilizers at 0).
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServingEngine as RServingEngine
from repro_torch.configs import get_config as p_config
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine
from test_torch_ssm import PATTERN, _reference_state

torch.set_num_threads(1)
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"
ARCHS = [JAMBA, XLSTM]
PROMPTS = [np.array([3, 1, 4, 1, 5], np.int32),
           np.array([9, 8, 7], np.int32),
           np.array([2, 2, 2, 2, 2, 2, 2], np.int32),
           np.array([6], np.int32),
           np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], np.int32)]


def _models(arch):
    extra = PATTERN if arch == XLSTM else {}
    rcfg = replace(r_config(arch).reduced(), **extra)
    pcfg = replace(p_config(arch).reduced(), **extra)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.array, rparams), "cpu")
    return rcfg, rparams, pcfg, pparams


def _serve(engine_cls, config_cls, cfg, params, prompts, **scfg):
    eng = engine_cls(cfg, params, config_cls(**scfg))
    hs = [eng.submit(p) for p in prompts]
    eng.drain()
    return [h.tokens for h in hs]


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_prefill_at_exact_length(arch):
    """tests/test_serve.py's test_recurrent_families_prefill_exact: a padded
    token would enter the recurrent state, so the bucket is the length; the
    prefill's ``decode_step`` sees exactly the prompt."""
    _, _, pcfg, pparams = _models(arch)
    eng = ServingEngine(pcfg, pparams, ServeConfig(max_len=32, max_new_tokens=2))
    assert eng._bucket_for(5) == 5 and eng._bucket_for(17) == 17
    dense = p_config("minicpm-2b").reduced()
    assert ServingEngine(dense, PM.init_params(dense, torch.Generator().manual_seed(0)),
                         ServeConfig(max_len=32))._bucket_for(5) == 16
    seen, real = [], PM.decode_step

    def decode_step(cfg, params, state, tokens):
        seen.append(tuple(tokens.shape))
        return real(cfg, params, state, tokens)

    PM.decode_step = decode_step
    try:
        assert len(eng.submit(np.array([1, 2, 3, 4, 5], np.int32)).result()) == 2
    finally:
        PM.decode_step = real
    assert seen == [(1, 5)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference_engine(arch, monkeypatch):
    """Greedy tokens, token for token, two slots and five prompts (slots
    refill as requests finish)."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    if arch == XLSTM:
        monkeypatch.setattr(RM, "init_decode_state",
                            lambda cfg, b, s_max, ring=True: _reference_state(cfg, b, s_max))
    kw = dict(batch_slots=2, max_len=64, max_new_tokens=6)
    want = _serve(RServingEngine, RServeConfig, rcfg, rparams, PROMPTS, **kw)
    assert _serve(ServingEngine, ServeConfig, pcfg, pparams, PROMPTS, **kw) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_refills_mid_stream(arch):
    """eos ends one request while the other slot decodes on: the freed slot
    takes the next request's prefilled states (every layer's, attention
    cache and recurrent states alike) and nobody's tokens change against
    each request served alone."""
    _, _, pcfg, pparams = _models(arch)
    prompts = PROMPTS[:3]
    alone = [_serve(ServingEngine, ServeConfig, pcfg, pparams, [p], batch_slots=1, max_len=64,
                    max_new_tokens=8)[0] for p in prompts]
    eos = alone[0][3]
    assert eos not in alone[1] and eos not in alone[2], "test prompt collision"
    eng = ServingEngine(pcfg, pparams, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=8,
                                                   eos_id=eos))
    writes, real = [], PM.write_slot

    def write_slot(states, i, state):
        writes.append(i)
        out = real(states, i, state)
        for dst, src in zip(out["layers"], state["layers"]):
            for d, t in zip(dst, src):
                assert torch.equal(d[i], t[0])
        return out

    PM.write_slot = write_slot
    try:
        hs = [eng.submit(p) for p in prompts]
        eng.drain()
    finally:
        PM.write_slot = real
    assert writes == [0, 1, 0]  # the third request takes the first one's slot
    assert [h.tokens for h in hs] == [alone[0][:4], alone[1], alone[2]]


@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_copies_every_layer_state(arch):
    _, _, pcfg, pparams = _models(arch)
    states = PM.init_slot_states(pcfg, 3, 16, device="cpu")
    before = [[t.clone() for t in st] for st in states["layers"]]
    one = PM.init_decode_state(pcfg, 1, 16, ring=False, device="cpu")
    _, one = PM.decode_step(pcfg, pparams, one, torch.tensor([[5, 6, 7]]))
    PM.write_slot(states, 1, one)
    assert states["len"].tolist() == [0, 3, 0]
    for st, old, src in zip(states["layers"], before, one["layers"]):
        for t, o, s in zip(st, old, src):
            assert torch.equal(t[1], s[0])
            assert torch.equal(t[0], o[0]) and torch.equal(t[2], o[2])
