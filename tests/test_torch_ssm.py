"""The port's ``ssm`` family (xLSTM-350M: mLSTM and sLSTM layers, no FFN)
against the reference's ``repro.models`` at reduced size, in fp32 on the CPU.

``reduced()`` keeps the pattern ``mmmm`` and would never run an sLSTM, so
the model here is the reduced one with the pattern ``("m", "s")`` over 4
layers (two periods).  Parameters come from the reference's ``init_params``
and are carried across with ``params_from_numpy``; tokens, inputs and states
come from numpy.  Outputs are compared with tests/test_models.py's tolerance
(2e-3).

The reference's decode states start both stabilizers at 0: its
``init_decode_state`` stacks each period's fresh state with ``jnp.zeros``
(``repro/models/model.py:341-347``), which drops ``_empty_state``'s ``m =
-1e30``, so its decode path leaves its own ``forward`` as soon as an sLSTM
layer runs.  The port starts them at -1e30 and matches ``forward``.  Against
the reference's decode the port is held from states built as
``_empty_state`` builds them (``_reference_state``);
``test_reference_decode_state_zeroes_the_stabilizer`` pins the difference.
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
XLSTM = "xlstm-350m"
PATTERN = dict(block_pattern=("m", "s"), n_layers=4)
S = 20  # tokens of the forward compared in this file


def configs():
    return (replace(r_config(XLSTM).reduced(), **PATTERN),
            replace(p_config(XLSTM).reduced(), **PATTERN))


@functools.cache
def _models():
    rcfg, pcfg = configs()
    tree = jax.tree_util.tree_map(np.array, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tree, pcfg, params_from_numpy(pcfg, tree, "cpu")


@functools.cache
def _jitted(name):
    return jax.jit(functools.partial(getattr(RM, name), _models()[0]))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@functools.cache
def _reference_forward():
    rcfg, tree, _, _ = _models()
    toks = _tokens(rcfg, 1, S)
    return toks, np.asarray(_jitted("forward")(tree, {"tokens": jnp.asarray(toks)}))


def _reference_state(rcfg, b, s_max):
    """The reference's ``init_decode_state`` for this family, with each
    layer's state as its ``_empty_state`` builds it (the stabilizer at
    -1e30)."""
    n_periods = rcfg.n_layers // len(rcfg.block_pattern)
    return {"len": jnp.zeros((), jnp.int32), "periods": [
        tuple(jnp.broadcast_to(t, (n_periods,) + t.shape)
              for t in RM._empty_state(rcfg, rcfg.layer_kind(pos), b, s_max, jnp.float32))
        for pos in range(len(rcfg.block_pattern))]}


def _mixer(tree, l):
    period = len(_models()[0].block_pattern)
    return {k: v[l // period] for k, v in tree["periods"][l % period]["mixer"].items()}


def _state(rng, shapes):
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(12, 4), (10, 4), (10, 128), (1, 128)])
def test_mlstm_matches_reference(s, chunk, with_state):
    """``layers.mlstm`` alone across chunk boundaries (S a chunk multiple and
    not, padded with logi = -1e30), in one chunk, and one decode step; with a
    carried (C, n, m)."""
    rcfg, tree, pcfg, _ = _models()
    mx = _mixer(tree, 0)
    rng = np.random.default_rng(s + chunk)
    h, dh = rcfg.n_heads, rcfg.d_model // rcfg.n_heads
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    state = _state(rng, [(2, h, dh, dh), (2, h, dh), (2, h)]) if with_state else None
    want, wst = RL.mlstm(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, mx), rcfg,
                         state=None if state is None else tuple(map(jnp.asarray, state)),
                         chunk=chunk)
    got, gst = PL.mlstm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in mx.items()},
                        pcfg, state=None if state is None else tuple(map(torch.from_numpy, state)),
                        chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(gst, wst):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [9, 1])
def test_slstm_matches_reference(s, with_state):
    rcfg, tree, pcfg, _ = _models()
    mx = _mixer(tree, 1)
    rng = np.random.default_rng(s)
    d = rcfg.d_model
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    state = _state(rng, [(2, d)] * 3) if with_state else None
    want, wst = RL.slstm(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, mx), rcfg,
                         state=None if state is None else tuple(map(jnp.asarray, state)))
    got, gst = PL.slstm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in mx.items()},
                        pcfg, state=None if state is None else tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(gst, wst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_params_and_states_follow_the_pattern():
    """``params_from_numpy`` reads ``periods`` (layer l = g * 2 + pos), blocks
    have no FFN (d_ff = 0), and each layer's decode state has its kind's
    shapes, the stabilizer at -1e30."""
    rcfg, tree, pcfg, pparams = _models()
    assert [pcfg.layer_kind(l) for l in range(4)] == ["mlstm", "slstm", "mlstm", "slstm"]
    for l, blk in enumerate(pparams["layers"]):
        assert set(blk) == {"norm1", "mixer"}
        for name, w in blk["mixer"].items():
            np.testing.assert_array_equal(w.numpy(), _mixer(tree, l)[name])
    own = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    assert [{k: tuple(v.shape) for k, v in b["mixer"].items()} for b in own["layers"]] == \
        [{k: tuple(v.shape) for k, v in b["mixer"].items()} for b in pparams["layers"]]
    st = PM.init_decode_state(pcfg, 2, 16, device="cpu")
    h, d = pcfg.n_heads, pcfg.d_model
    dh = d // h
    assert [tuple(tuple(t.shape) for t in s) for s in st["layers"]] == \
        [((2, h, dh, dh), (2, h, dh), (2, h)), ((2, d),) * 3] * 2
    assert all(bool((s[2] == -1e30).all()) for s in st["layers"])


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
    """tests/test_models.py's test_decode_matches_forward with sLSTM layers:
    the port's stepwise decode reproduces the reference's forward."""
    _, _, pcfg, pparams = _models()
    toks, want = _reference_forward()
    state = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    outs = []
    for t in range(S):
        logits, state = PM.decode_step(pcfg, pparams, state, torch.from_numpy(toks[:, t:t + 1]))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want, **TOL)


def test_reference_decode_state_zeroes_the_stabilizer():
    """A reference fault the port does not copy: the reference's decode
    state holds m = 0 where ``_empty_state`` says -1e30, and its prefill then
    leaves its own forward by far more than the tolerance; from
    ``_empty_state``'s states it agrees with forward, and so does the port's
    prefill."""
    rcfg, tree, pcfg, pparams = _models()
    toks, want = _reference_forward()
    own = RM.init_decode_state(rcfg, 1, 32, ring=False)
    assert all(float(jnp.abs(s[2]).max()) == 0.0 for s in own["periods"])
    assert all(bool((s[2] == np.float32(-1e30)).all())
               for s in _reference_state(rcfg, 1, 32)["periods"])
    faulty, _ = _jitted("decode_step")(tree, own, jnp.asarray(toks))
    fixed, _ = _jitted("decode_step")(tree, _reference_state(rcfg, 1, 32), jnp.asarray(toks))
    assert float(np.abs(np.asarray(faulty) - want).max()) > 1e-2
    np.testing.assert_allclose(np.asarray(fixed), want, **TOL)
    got, _ = PM.decode_step(pcfg, pparams, PM.init_decode_state(pcfg, 1, 32, ring=False,
                                                                device="cpu"),
                            torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_then_decode_matches_reference():
    """A 6-token prefill then 4 decode steps in both packages (the
    reference from ``_empty_state``'s states), logits and every layer's
    state after them."""
    rcfg, tree, pcfg, pparams = _models()
    toks = _tokens(rcfg, 1, 10, seed=3)
    rs = _reference_state(rcfg, 1, 32)
    ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    for a, b in [(0, 6)] + [(t, t + 1) for t in range(6, 10)]:
        want, rs = _jitted("decode_step")(tree, rs, jnp.asarray(toks[:, a:b]))
        got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, a:b]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for l, st in enumerate(ps["layers"]):
        for g, w in zip(st, rs["periods"][l % 2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w[l // 2]), **TOL)


def test_decode_slots_match_reference_per_slot():
    """Three slots at their own lengths: the port's one batched step against
    the reference's ``vmap`` of per-slot ``decode_step``."""
    rcfg, tree, pcfg, pparams = _models()
    rstates = RM.init_slot_states(rcfg, 3, 32)
    pstates = PM.init_slot_states(pcfg, 3, 32, device="cpu")
    for i, n in enumerate((5, 2, 9)):
        toks = _tokens(rcfg, 1, n, seed=10 + i)
        rs = _reference_state(rcfg, 1, 32)
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


def test_plain_layer_composes_the_plain_forward():
    """``plain.layer`` applied layer after layer from the embeddings, then
    the final norm and head, is ``plain.forward``."""
    from repro_torch.kernels import ref

    _, _, pcfg, pparams = _models()
    toks, want = _reference_forward()
    x = pparams["embed"][torch.from_numpy(toks[0]).long()].float()
    for l, blk in enumerate(pparams["layers"]):
        x = plain.layer(pcfg, blk, l, x)
    got = ref.rmsnorm(x, pparams["final_norm"].float(), eps=pcfg.norm_eps) @ pparams["lm_head"]
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)
