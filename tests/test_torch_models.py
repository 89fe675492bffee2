"""The port's decoders (``repro_torch.models``: dense, and Mixtral's MoE)
against the reference's ``repro.models.model`` at reduced size, in fp32 on
the CPU.

Parameters come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; tokens come from numpy.  Logits are compared with
tests/test_models.py's tolerance (2e-3).  H2O-Danube's reduced window is 64,
so sequences of 100 make the window mask in ``forward``.
"""
import functools
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro_torch.configs import get_config as p_config
from repro_torch.models import model as PM
from repro_torch.models import plain
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py
ARCHS = ["h2o-danube-3-4b", "minicpm-2b", "mixtral-8x7b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, pcfg = r_config(arch).reduced(), p_config(arch).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, rparams, pcfg, pparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_configs_are_copies():
    from repro.configs import ARCHS as R_ARCHS
    from repro_torch.configs import ARCHS as P_ARCHS

    assert sorted(R_ARCHS) == sorted(P_ARCHS)
    for name in R_ARCHS:
        assert vars(R_ARCHS[name]) == vars(P_ARCHS[name])
        assert vars(R_ARCHS[name].reduced()) == vars(P_ARCHS[name].reduced())


def test_forward_matches_reference(model):
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 2, 100)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)}))
    got = PM.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 100, pcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_forward_matches_reference(model):
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 1, 100, seed=1)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)}))[0]
    np.testing.assert_allclose(plain.forward(pcfg, pparams, torch.from_numpy(toks[0])).numpy(),
                               want, **TOL)


def test_plain_forward_in_tiles_matches_reference(model, monkeypatch):
    """Above its threshold the plain forward takes chunked attention (as at
    8192 tokens on the card): force that at 100 tokens."""
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 1, 100, seed=2)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)}))[0]
    monkeypatch.setattr(plain, "CHUNKED_ABOVE", 0)
    np.testing.assert_allclose(plain.forward(pcfg, pparams, torch.from_numpy(toks[0])).numpy(),
                               want, **TOL)


def test_init_params_has_the_reference_layout(model):
    rcfg, rparams, pcfg, pparams = model
    own = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    flat = lambda p: {k: tuple(v.shape) for k, v in _flatten(p)}  # noqa: E731
    assert flat(own) == flat(pparams)
    assert all(v.dtype == torch.float32 for _, v in _flatten(own))
    assert torch.equal(own["layers"][0]["norm1"], torch.ones(pcfg.d_model))


def _flatten(p, prefix=""):
    if isinstance(p, dict):
        for k, v in p.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(p, list):
        for i, v in enumerate(p):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, p


@functools.lru_cache(maxsize=None)
def _jitted(fn, rcfg):
    return jax.jit(partial(fn, rcfg))


def _ref_decode(rcfg, rparams, state, toks):
    logits, state = _jitted(RM.decode_step, rcfg)(rparams, state, jnp.asarray(toks))
    return np.asarray(logits), state


@pytest.mark.parametrize("prefill", [6, 40])
def test_prefill_then_decode_matches_reference_full_cache(model, prefill):
    """Prefill s > 1, then decode s = 1, on a full cache of 128 — past the
    reduced window (64) for Danube, where the cache path ignores the window
    just as the reference's does (repro/models/layers.py:167)."""
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 2, 100, seed=3)
    rs = RM.init_decode_state(rcfg, 2, 128, ring=False)
    ps = PM.init_decode_state(pcfg, 2, 128, ring=False, device="cpu")
    want, rs = _ref_decode(rcfg, rparams, rs, toks[:, :prefill])
    got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, :prefill]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for t in range(prefill, 100):
        want, rs = _ref_decode(rcfg, rparams, rs, toks[:, t:t + 1])
        got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ps["len"] == int(rs["len"]) == 100


def test_full_cache_ignores_the_window_like_the_reference(model):
    """Pins the reference's behaviour: beyond ``window`` positions the
    cache path's logits differ from ``forward``'s (which applies it), in the
    port exactly as in the reference; below it they agree."""
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 1, 100, seed=4)
    fwd = PM.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks)}).numpy()
    ps = PM.init_decode_state(pcfg, 1, 128, ring=False, device="cpu")
    got, _ = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks))
    want, _ = _ref_decode(rcfg, rparams, RM.init_decode_state(rcfg, 1, 128, ring=False), toks)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    w = pcfg.window or 100
    np.testing.assert_allclose(got.numpy()[:, :w], fwd[:, :w], **TOL)
    if pcfg.window is not None:
        assert np.abs(got.numpy()[:, w:] - fwd[:, w:]).max() > 1e-1


def test_ring_cache_decode_matches_reference(model):
    """A window-sized ring cache (Danube) decoded past the window, token by
    token: write positions wrap and the offset caps the causal test."""
    rcfg, rparams, pcfg, pparams = model
    toks = _tokens(rcfg, 1, 90, seed=5)
    s_max = pcfg.window or 32
    rs = RM.init_decode_state(rcfg, 1, s_max, ring=True)
    ps = PM.init_decode_state(pcfg, 1, s_max, ring=True, device="cpu")
    assert ps["layers"][0].shape[3] == rs["layers"][0].shape[2]
    steps = 90 if pcfg.window else s_max
    for t in range(steps):
        want, rs = _ref_decode(rcfg, rparams, rs, toks[:, t:t + 1])
        got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _slot_states(rcfg, rparams, pcfg, pparams, prompts, s_max=64):
    rs = RM.init_slot_states(rcfg, len(prompts), s_max)
    ps = PM.init_slot_states(pcfg, len(prompts), s_max, device="cpu")
    for i, prompt in enumerate(prompts):
        one_r = RM.init_decode_state(rcfg, 1, s_max, ring=False)
        _, one_r = _ref_decode(rcfg, rparams, one_r, prompt[None])
        rs = RM.write_slot(rs, i, one_r)
        one_p = PM.init_decode_state(pcfg, 1, s_max, ring=False, device="cpu")
        _, one_p = PM.decode_step(pcfg, pparams, one_p, torch.from_numpy(prompt[None]))
        ps = PM.write_slot(ps, i, one_p)
    return rs, ps


def test_decode_slots_at_different_lengths_match_reference(model):
    rcfg, rparams, pcfg, pparams = model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32) for n in (1, 7, 20)]
    rs, ps = _slot_states(rcfg, rparams, pcfg, pparams, prompts)
    assert ps["len"].tolist() == [1, 7, 20]
    toks = np.array([p[-1] for p in prompts], np.int32)
    r_step = _jitted(RM.decode_slots, rcfg)
    for _ in range(5):
        want, rs = r_step(rparams, rs, jnp.asarray(toks))
        got, ps = PM.decode_slots(pcfg, pparams, ps, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        toks = np.asarray(want).argmax(-1).astype(np.int32)
    assert ps["len"].tolist() == [6, 12, 25]


def test_decode_slots_greedy_matches_reference(model):
    rcfg, rparams, pcfg, pparams = model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32) for n in (3, 12, 5, 30)]
    rs, ps = _slot_states(rcfg, rparams, pcfg, pparams, prompts)
    rt = jnp.asarray([p[-1] for p in prompts], jnp.int32)
    pt = torch.from_numpy(np.array([p[-1] for p in prompts], np.int32))
    r_step = _jitted(RM.decode_slots_greedy, rcfg)
    for _ in range(8):
        rt, rs = r_step(rparams, rs, rt)
        pt, ps = PM.decode_slots_greedy(pcfg, pparams, ps, pt)
        assert pt.dtype == torch.int32
        assert pt.tolist() == np.asarray(rt).tolist()


def test_write_slot_replaces_cache_and_length(model):
    _, _, pcfg, pparams = model
    states = PM.init_slot_states(pcfg, 3, 16, device="cpu")
    one = PM.init_decode_state(pcfg, 1, 16, ring=False, device="cpu")
    _, one = PM.decode_step(pcfg, pparams, one, torch.tensor([[5, 6, 7]]))
    PM.write_slot(states, 1, one)
    assert states["len"].tolist() == [0, 3, 0]
    assert torch.equal(states["layers"][0][:, 1], one["layers"][0][:, 0])
    assert not states["layers"][1][:, 0].any() and not states["layers"][1][:, 2].any()


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_other_families_are_not_ported_yet(arch):
    """The ssm and hybrid families were the last of the reference's to be
    ported (tests/test_torch_ssm.py, tests/test_torch_hybrid.py); a family
    the reference does not have is still refused everywhere."""
    cfg = p_config(arch).reduced()
    PM.check_family(cfg)
    assert set(PM.PORTED_FAMILIES) == {"dense", "moe", "vlm", "audio", "hybrid", "ssm"}
    other = replace(cfg, family="diffusion")
    with pytest.raises(NotImplementedError):
        PM.init_params(other, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        PM.init_decode_state(other, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        plain.forward(other, {}, torch.zeros(4, dtype=torch.int64))


def test_qkv_bias_matches_reference():
    """Qwen1.5-32B is dense with q/k/v biases: random biases, carried
    across, in ``forward``, ``decode_step`` and the plain forward."""
    rcfg, pcfg = r_config("qwen1.5-32b").reduced(), p_config("qwen1.5-32b").reduced()
    tree = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(9)
    for name in ("bq", "bk", "bv"):
        b = tree["layers"]["mixer"][name]
        tree["layers"]["mixer"][name] = rng.normal(size=b.shape).astype(np.float32) * 0.5
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    pparams = params_from_numpy(pcfg, tree, "cpu")
    toks = _tokens(rcfg, 1, 24, seed=10)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks)}))
    got = PM.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(plain.forward(pcfg, pparams, torch.from_numpy(toks[0])).numpy(),
                               want[0], **TOL)
    ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    step, _ = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks))
    np.testing.assert_allclose(step.numpy(), want, **TOL)
