"""The port's ``hybrid`` family (Jamba-1.5-Large: attention and Mamba layers,
MoE on every second layer) against the reference's ``repro.models`` at
reduced size (one full 8-layer period), in fp32 on the CPU.

Parameters come from the reference's ``init_params`` (its ``periods``
layout) and are carried across with ``params_from_numpy``; tokens and states
come from numpy.  Outputs are compared with tests/test_models.py's tolerance
(2e-3).  The reference's calls are jitted once per shape and reused, so each
shape compiles once in this file.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config as p_config
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import plain
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py
JAMBA = "jamba-1.5-large-398b"
S = 20  # tokens of the forward compared in this file


@functools.cache
def _models():
    rcfg, pcfg = r_config(JAMBA).reduced(), p_config(JAMBA).reduced()
    tree = jax.tree_util.tree_map(np.array, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tree, pcfg, params_from_numpy(pcfg, tree, "cpu")


@functools.cache
def _jitted(name):
    rcfg = _models()[0]
    return jax.jit(functools.partial(getattr(RM, name), rcfg))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@functools.cache
def _reference_forward():
    _, tree, _, _ = _models()
    toks = _tokens(_models()[0], 1, S)
    return toks, np.asarray(_jitted("forward")(tree, {"tokens": jnp.asarray(toks)}))


def _layer(tree, l, period=8):
    """Layer ``l``'s block of a reference tree in the ``periods`` layout."""
    return jax.tree_util.tree_map(lambda a: a[l // period], tree["periods"][l % period])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 4), (19, 4), (19, 256), (1, 256)])
def test_mamba_matches_reference(s, chunk, with_state):
    """``layers.mamba`` alone: S a chunk multiple and not (padded with
    dt = 0), a single chunk, one decode step; with a carried conv buffer and
    state the conv and the scan continue from them."""
    rcfg, tree, pcfg, _ = _models()
    mx = _layer(tree, 1)["mixer"]  # layer 1 is Mamba
    rng = np.random.default_rng(s + chunk)
    din, n = rcfg.mamba_expand * rcfg.d_model, rcfg.mamba_d_state
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, rcfg.mamba_d_conv - 1, din)).astype(np.float32),
                 rng.standard_normal((2, din, n)).astype(np.float32))
    want, (wbuf, wh) = RL.mamba(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, mx), rcfg,
                                state=None if state is None else tuple(map(jnp.asarray, state)),
                                chunk=chunk)
    got, (gbuf, gh) = PL.mamba(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in mx.items()}, pcfg,
        state=None if state is None else tuple(map(torch.from_numpy, state)), chunk=chunk)
    assert gh.dtype == torch.float32 and gbuf.shape == (2, rcfg.mamba_d_conv - 1, din)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gbuf.numpy(), np.asarray(wbuf), **TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)


def test_mamba_scan_never_holds_the_whole_sequence(monkeypatch):
    """The chunked scan's (B, Q, Din, N) transitions exist one chunk at a
    time: every ``exp`` it takes has Q positions, never S."""
    _, tree, pcfg, _ = _models()
    mx = {k: torch.from_numpy(v) for k, v in _layer(tree, 1)["mixer"].items()}
    shapes, real = [], torch.exp

    def exp(t, *a, **kw):
        shapes.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(torch, "exp", exp)
    PL.mamba(torch.zeros((1, 40, pcfg.d_model)), mx, pcfg, chunk=8)
    scan = [sh for sh in shapes if len(sh) == 4]
    assert len(scan) == 5 and all(sh[1] == 8 for sh in scan)


def test_params_from_numpy_reads_periods():
    """Two periods (16 layers): the reference's ``periods[pos]`` at index g is
    the port's layer ``g * 8 + pos``, with its kind's mixer and its FFN (MoE
    on odd layers)."""
    rcfg, pcfg = replace(r_config(JAMBA).reduced(), n_layers=16), \
        replace(p_config(JAMBA).reduced(), n_layers=16)
    tree = jax.tree_util.tree_map(np.array, RM.init_params(rcfg, jax.random.PRNGKey(1)))
    p = params_from_numpy(pcfg, tree, "cpu")
    assert len(p["layers"]) == 16
    for l, blk in enumerate(p["layers"]):
        want = _layer(tree, l)
        assert ("wq" in blk["mixer"]) == (l % 8 == 0)
        assert ("in_proj" in blk["mixer"]) == (l % 8 != 0)
        assert ("router" in blk["ffn"]) == (l % 2 == 1)
        for k in ("mixer", "ffn"):
            for name, w in blk[k].items():
                np.testing.assert_array_equal(w.numpy(), want[k][name])
    own = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    assert [{k: tuple(v.shape) for k, v in b["mixer"].items()} for b in own["layers"]] == \
        [{k: tuple(v.shape) for k, v in b["mixer"].items()} for b in p["layers"]]
    assert own["layers"][1]["mixer"]["A_log"].dtype == torch.float32


def test_forward_matches_reference():
    _, _, pcfg, pparams = _models()
    toks, want = _reference_forward()
    got = PM.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_forward_matches_reference():
    _, _, pcfg, pparams = _models()
    toks, want = _reference_forward()
    got = plain.forward(pcfg, pparams, torch.from_numpy(toks[0]))
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)


def test_decode_steps_match_forward():
    """tests/test_models.py's test_decode_matches_forward: the port's
    stepwise decode (attention caches, Mamba states) reproduces the
    reference's teacher-forced forward."""
    _, _, pcfg, pparams = _models()
    toks, want = _reference_forward()
    state = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    outs = []
    for t in range(S):
        logits, state = PM.decode_step(pcfg, pparams, state, torch.from_numpy(toks[:, t:t + 1]))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want, **TOL)
    assert state["len"] == S


def test_prefill_then_decode_matches_reference():
    """A 6-token prefill then 4 decode steps in both packages, logits and
    every layer's state after each call."""
    rcfg, tree, pcfg, pparams = _models()
    toks = _tokens(rcfg, 1, 10, seed=3)
    rs = RM.init_decode_state(rcfg, 1, 32, ring=False)
    ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    for a, b in [(0, 6)] + [(t, t + 1) for t in range(6, 10)]:
        want, rs = _jitted("decode_step")(tree, rs, jnp.asarray(toks[:, a:b]))
        got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, a:b]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for l, st in enumerate(ps["layers"]):
        ref = [np.asarray(t[l // 8]) for t in rs["periods"][l % 8]]
        if l % 8 == 0:  # the reference's cache is (B, S, KV, Dh)
            ref = [r.transpose(0, 2, 1, 3) for r in ref]
        for g, w in zip(st, ref):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_decode_slots_match_reference_per_slot():
    """Three slots at their own lengths (each filled by one-token steps, so
    the reference compiles one step): the port's one batched step against the
    reference's ``vmap`` of per-slot ``decode_step``; MoE layers dispatch the
    three slots together and drop nothing."""
    rcfg, tree, pcfg, pparams = _models()
    rstates = RM.init_slot_states(rcfg, 3, 32)
    pstates = PM.init_slot_states(pcfg, 3, 32, device="cpu")
    for i, n in enumerate((5, 2, 9)):
        toks = _tokens(rcfg, 1, n, seed=10 + i)
        rs = RM.init_decode_state(rcfg, 1, 32, ring=False)
        ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
        for t in range(n):
            _, rs = _jitted("decode_step")(tree, rs, jnp.asarray(toks[:, t:t + 1]))
            _, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, t:t + 1]))
        rstates = RM.write_slot(rstates, i, rs)
        PM.write_slot(pstates, i, ps)
    tok = np.array([7, 11, 13], np.int32)
    for _ in range(3):
        want, rstates = _jitted("decode_slots")(tree, rstates, jnp.asarray(tok))
        got, pstates = PM.decode_slots(pcfg, pparams, pstates, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want).argmax(-1).astype(np.int32)
    assert pstates["len"].tolist() == [8, 5, 12]


def test_four_layer_cut_matches_reference_with_identity_layers():
    """The card's Jamba stage: the port at ``n_layers=4`` (attention, then
    Mamba/MoE, Mamba/dense, Mamba/MoE) against the reference's 8-layer
    period whose layers 4-7 add 0 to the residual (zero ``out_proj``, zero
    dense ``wd`` and expert ``wd``); forward, the plain forward and a
    prefill."""
    rcfg, tree, pcfg, _ = _models()
    cut = jax.tree_util.tree_map(np.copy, tree)
    for pos in range(4, 8):
        cut["periods"][pos]["mixer"]["out_proj"][:] = 0
        cut["periods"][pos]["ffn"]["wd"][:] = 0
    toks = _tokens(rcfg, 1, S, seed=7)
    want = np.asarray(_jitted("forward")(cut, {"tokens": jnp.asarray(toks)}))
    pcfg4 = replace(pcfg, n_layers=4)
    full = params_from_numpy(pcfg, cut, "cpu")
    p4 = dict(full, layers=full["layers"][:4])
    assert [pcfg4.layer_kind(l) for l in range(4)] == ["attn", "mamba", "mamba", "mamba"]
    assert [pcfg4.layer_is_moe(l) for l in range(4)] == [False, True, False, True]
    np.testing.assert_allclose(PM.forward(pcfg4, p4, {"tokens": torch.from_numpy(toks)}).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(plain.forward(pcfg4, p4, torch.from_numpy(toks[0])).numpy(),
                               want[0], **TOL)
    st = PM.init_decode_state(pcfg4, 1, 32, ring=False, device="cpu")
    assert len(st["layers"]) == 4
    got, _ = PM.decode_step(pcfg4, p4, st, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
