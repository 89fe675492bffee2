"""The port's ``vlm`` (LLaVA-NeXT-Mistral-7B) and ``audio``
(SeamlessM4T-large-v2) families against the reference's
``repro.models.model`` at reduced size, in fp32 on the CPU; the serving path
(slot-batched decode, the engine) is in tests/test_torch_families_serve.py.

Parameters come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; tokens and frontend embeddings come from numpy.
Logits are compared with tests/test_models.py's tolerance (2e-3).  The
reduced Seamless config is multi-head (4 q and 4 kv heads), as the
published one is.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro_torch.configs import get_config as p_config
from repro_torch.models import layers as PLayers
from repro_torch.models import model as PM
from repro_torch.models import plain
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py
VLM, AUDIO = "llava-next-mistral-7b", "seamless-m4t-large-v2"
ARCHS = [VLM, AUDIO]


@functools.cache
def _models(arch):
    rcfg, pcfg = r_config(arch).reduced(), p_config(arch).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    return rcfg, rparams, pcfg, pparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _embeds(cfg, b, seed=0):
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal((b, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_reference_tree(arch):
    _, _, pcfg, pparams = _models(arch)
    own = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(pparams)
    if arch == AUDIO:
        assert len(own["encoder"]) == pcfg.enc_layers and len(own["decoder"]) == pcfg.n_layers
        assert {"norm_x", "cross"} <= set(own["decoder"][0]) and "layers" not in own


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_embeds_matches_reference(arch):
    rcfg, rparams, pcfg, pparams = _models(arch)
    toks, emb = _tokens(rcfg, 2, 20), _embeds(rcfg, 2)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks),
                                                 "embeds": jnp.asarray(emb)}))
    got = PM.forward(pcfg, pparams, {"tokens": torch.from_numpy(toks),
                                     "embeds": torch.from_numpy(emb)})
    assert got.shape == (2, 20, pcfg.vocab)  # vlm: the patch positions' logits dropped
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encode_matches_reference():
    rcfg, rparams, pcfg, pparams = _models(AUDIO)
    emb = _embeds(rcfg, 2, seed=1)
    want = np.asarray(RM.encode(rcfg, rparams, jnp.asarray(emb)))
    got = PM.encode(pcfg, pparams, torch.from_numpy(emb))
    assert got.shape == (2, pcfg.frontend_len, pcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_audio_decode_matches_forward():
    """tests/test_models.py's test_decode_matches_forward: stepwise decode
    over the encoded memory reproduces the reference's teacher-forced
    forward."""
    rcfg, rparams, pcfg, pparams = _models(AUDIO)
    toks, emb = _tokens(rcfg, 2, 8, seed=2), _embeds(rcfg, 2, seed=2)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks),
                                                 "embeds": jnp.asarray(emb)}))
    state = PM.init_decode_state(pcfg, 2, 32, ring=False, device="cpu")
    assert state["memory"].shape == (2, pcfg.frontend_len, pcfg.d_model)
    state["memory"] = PM.encode(pcfg, pparams, torch.from_numpy(emb))
    outs = []
    for t in range(8):
        logits, state = PM.decode_step(pcfg, pparams, state, torch.from_numpy(toks[:, t:t + 1]))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """A 6-token prefill then 4 decode steps in both packages (vlm: text only,
    as the engines serve it; audio: over an encoded memory)."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    toks = _tokens(rcfg, 1, 10, seed=3)
    rs = RM.init_decode_state(rcfg, 1, 32, ring=False)
    ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
    if arch == AUDIO:
        emb = _embeds(rcfg, 1, seed=3)
        rs["memory"] = RM.encode(rcfg, rparams, jnp.asarray(emb))
        ps["memory"] = PM.encode(pcfg, pparams, torch.from_numpy(emb))
    for a, b in [(0, 6)] + [(t, t + 1) for t in range(6, 10)]:
        want, rs = RM.decode_step(rcfg, rparams, rs, jnp.asarray(toks[:, a:b]))
        got, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks[:, a:b]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_forward_matches_reference(arch, chunked, monkeypatch):
    """The fp32 yardstick with the frontend embeddings; ``chunked`` forces
    its tiled attention (the card's path at 4096 frames), cross-attention's
    Sq != Skv included."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    toks, emb = _tokens(rcfg, 1, 20, seed=4), _embeds(rcfg, 1, seed=4)
    want = np.asarray(RM.forward(rcfg, rparams, {"tokens": jnp.asarray(toks),
                                                 "embeds": jnp.asarray(emb)}))[0]
    if chunked:
        monkeypatch.setattr(plain, "CHUNKED_ABOVE", 0)
    got = plain.forward(pcfg, pparams, torch.from_numpy(toks[0]),
                        embeds=torch.from_numpy(emb[0]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_forward_text_only_vlm_matches_reference_prefill():
    """Without patch embeddings the yardstick is what the engines serve:
    the reference's text-only prefill logits."""
    rcfg, rparams, pcfg, pparams = _models(VLM)
    toks = _tokens(rcfg, 1, 12, seed=5)
    want, _ = RM.decode_step(rcfg, rparams, RM.init_decode_state(rcfg, 1, 16, ring=False),
                             jnp.asarray(toks))
    got = plain.forward(pcfg, pparams, torch.from_numpy(toks[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], **TOL)


def test_attention_memory_layer_matches_reference():
    """``layers.attention(memory=...)`` alone, against the reference's."""
    from repro.models import layers as RLayers

    rcfg, rparams, pcfg, pparams = _models(AUDIO)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, rcfg.frontend_len, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    rblk = jax.tree_util.tree_map(lambda a: a[0], rparams["decoder"])["cross"]
    want, _ = RLayers.attention(jnp.asarray(x), rblk, rcfg, positions=jnp.asarray(pos),
                                causal=False, memory=jnp.asarray(mem))
    got = PLayers.attention(torch.from_numpy(x), pparams["decoder"][0]["cross"], pcfg,
                            positions=torch.from_numpy(pos.copy()), causal=False,
                            memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
