"""The port's ``vlm`` and ``audio`` families on the serving path: the
slot-batched decode with one encoder memory per slot, its K5 calls, and the
serving engine, against the reference's ``repro.models.model`` and
``repro.serve.ServingEngine`` at reduced size, in fp32 on the CPU (split from
tests/test_torch_families.py to keep each file well under a minute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServingEngine as RServingEngine
from repro_torch.kernels import ops
from repro_torch.models import model as PM
from repro_torch.serve import ServeConfig, ServingEngine
from test_torch_families import ARCHS, AUDIO, TOL, _embeds, _models, _tokens

torch.set_num_threads(1)


def test_decode_slots_match_reference_per_slot():
    """Three audio slots at their own lengths, each over its own memory: the
    port's one batched step against the reference's ``vmap`` of per-slot
    ``decode_step``."""
    rcfg, rparams, pcfg, pparams = _models(AUDIO)
    rstates = RM.init_slot_states(rcfg, 3, 32)
    pstates = PM.init_slot_states(pcfg, 3, 32, device="cpu")
    for i, n in enumerate((5, 2, 9)):
        toks = _tokens(rcfg, 1, n, seed=10 + i)
        rs = RM.init_decode_state(rcfg, 1, 32, ring=False)
        ps = PM.init_decode_state(pcfg, 1, 32, ring=False, device="cpu")
        emb = _embeds(rcfg, 1, seed=10 + i)
        rs["memory"] = RM.encode(rcfg, rparams, jnp.asarray(emb))
        ps["memory"] = PM.encode(pcfg, pparams, torch.from_numpy(emb))
        _, rs = RM.decode_step(rcfg, rparams, rs, jnp.asarray(toks))
        _, ps = PM.decode_step(pcfg, pparams, ps, torch.from_numpy(toks))
        rstates = RM.write_slot(rstates, i, rs)
        PM.write_slot(pstates, i, ps)
        assert torch.equal(pstates["memory"][i], ps["memory"][0])
    tok = np.array([7, 11, 13], np.int32)
    for _ in range(3):
        want, rstates = RM.decode_slots(rcfg, rparams, rstates, jnp.asarray(tok))
        got, pstates = PM.decode_slots(pcfg, pparams, pstates, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want).argmax(-1).astype(np.int32)
    assert pstates["len"].tolist() == [8, 5, 12]


def test_cross_attention_runs_k5_non_causal_over_memory(monkeypatch):
    """Each decoder block's cross-attention hands K5 fresh memory K/V of
    ``frontend_len`` keys, non-causal, with no window and offset 0, whatever
    the cache arguments say; self-attention keeps the slots' offsets."""
    _, _, pcfg, pparams = _models(AUDIO)
    states = PM.init_slot_states(pcfg, 2, 16, device="cpu")
    states["memory"].normal_(generator=torch.Generator().manual_seed(0))
    states["len"][:] = torch.tensor([3, 7], dtype=torch.int32)
    calls, real = [], ops.attention

    def attention(q, k, v, **kw):
        calls.append((q.shape, k.shape, k.is_contiguous(), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", attention)
    PM.decode_slots(pcfg, pparams, states, torch.tensor([1, 2]))
    h, kv, dh = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
    assert len(calls) == 2 * pcfg.n_layers
    for (qs, ks, contiguous, kw) in calls[1::2]:  # self, cross, self, cross, ...
        assert qs == (2 * h, 1, dh) and ks == (2 * kv, pcfg.frontend_len, dh) and contiguous
        assert kw == dict(causal=False, window=None, q_offset=0)
    for (_, ks, _, kw) in calls[0::2]:
        assert ks == (2 * kv, 16, dh) and kw["causal"] and kw["q_offset"].tolist() == \
            [3] * h + [7] * h


PROMPTS = [np.array([3, 1, 4, 1, 5], np.int32),
           np.array([9, 8, 7], np.int32),
           np.array([2, 2, 2, 2, 2, 2, 2], np.int32),
           np.array([6], np.int32)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """Greedy tokens, token for token; the audio engines encode zero frames
    per request at prefill, vlm is served text-only."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    kw = dict(batch_slots=2, max_len=64, max_new_tokens=6)
    reng = RServingEngine(rcfg, rparams, RServeConfig(**kw))
    rhs = [reng.submit(p) for p in PROMPTS]
    reng.drain()
    eng = ServingEngine(pcfg, pparams, ServeConfig(**kw))
    hs = [eng.submit(p) for p in PROMPTS]
    eng.drain()
    assert [h.tokens for h in hs] == [h.tokens for h in rhs]
    assert all(len(h.tokens) == 6 for h in hs)
