"""The port's MoE layer (``repro_torch.models.layers.moe_ffn``), its grouped
matmul (K6's plain version) and the ``moe`` family's decode, held against
the reference at Mixtral 8x7B's reduced config in fp32 on the CPU.

Inputs come from numpy seeds.  The "biased" router sends every token to
expert 0 (a constant coordinate of the MoE input times a large router entry),
so capacity drops certainly happen where the token count allows them.
Tolerances: tests/test_kernels.py's 2e-4 for the grouped matmul,
tests/test_models.py's 2e-3 for logits, 2e-5 for one fp32 MoE layer.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.kernels import ref as r_ref
from repro.kernels.moe_gmm import grouped_matmul as r_gmm
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config as p_config
from repro_torch.kernels import moe_gmm as p_gmm
from repro_torch.kernels import ops as p_ops
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import plain
from repro_torch.models.convert import params_from_numpy
from test_torch_card import bf16_ulp

torch.set_num_threads(1)
ARCH = "mixtral-8x7b"
GMM_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernels.py
TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_models.py
FFN_TOL = dict(rtol=2e-5, atol=2e-5)
BIAS = 20.0  # the biased inputs' constant coordinate 0 (the router's entry is 10)


@pytest.fixture(scope="module")
def cfgs():
    return r_config(ARCH).reduced(), p_config(ARCH).reduced()


def _params(rcfg, pcfg, biased: bool, seed: int = 0):
    """Reference parameters (as numpy) and the port's copy.  Biased: every
    token embedding gets coordinate 0 = BIAS, which dominates the residual
    stream, and every router maps coordinate 0 to expert 0 alone."""
    tree = jax.tree_util.tree_map(np.array, RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    if biased:
        tree["embed"][:, 0] = BIAS
        router = tree["layers"]["ffn"]["router"]
        router[:, 0, :] = 0.0
        router[:, 0, 0] = 10.0
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return rparams, params_from_numpy(pcfg, tree, "cpu")


# ---------------------------------------------------------------------------
# capacity and the grouped matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("capacity", [PL.moe_capacity, plain.capacity],
                         ids=["engine", "yardstick"])
def test_moe_capacity_matches_reference(reduced, capacity):
    """The engine's capacity and the fp32 yardstick's own copy of it."""
    rcfg, pcfg = r_config(ARCH), p_config(ARCH)
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    got = [capacity(pcfg, t) for t in range(1, 4097)]
    assert got == [RL.moe_capacity(rcfg, t) for t in range(1, 4097)]
    assert capacity(p_config(ARCH), 2048) == 640 and capacity(p_config(ARCH), 1) == 8


@pytest.mark.parametrize("e,c,d,f", [(3, 13, 37, 29), (8, 10, 20, 12), (2, 33, 70, 17),
                                     (4, 1, 24, 40), (2, 128, 64, 64)])
def test_grouped_matmul_matches_reference(e, c, d, f):
    rng = np.random.default_rng(e * c + d * f)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    before = p_gmm.PLAIN["grouped_matmul"], p_gmm.LAUNCHES["grouped_matmul"]
    got = p_ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert (p_gmm.PLAIN["grouped_matmul"], p_gmm.LAUNCHES["grouped_matmul"]) == \
        (before[0] + 1, before[1])
    assert got.shape == (e, c, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(r_ref.grouped_matmul(x, w)), **GMM_TOL)
    interp = r_gmm(x, w, block_c=16, block_f=16, block_d=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), **GMM_TOL)


def test_grouped_matmul_bf16_within_one_ulp_of_reference():
    """Both round one fp32 product to bf16; the fp32 sums differ only in order."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 9, 40)).astype(np.float32)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32)
    want = np.asarray(r_ref.grouped_matmul(jnp.asarray(x, jnp.bfloat16),
                                           jnp.asarray(w, jnp.bfloat16)), np.float32)
    got = p_gmm.grouped_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(want)
    assert bool(((got.float() - want).abs() <= bf16_ulp(want)).all())


def test_grouped_matmul_rejects_bad_input():
    x, w = torch.ones(2, 3, 4), torch.ones(2, 4, 5)
    for a, b in [(x, torch.ones(3, 4, 5)), (x, torch.ones(2, 5, 5)), (x[0], w[0])]:
        with pytest.raises(ValueError):
            p_gmm.grouped_matmul(a, b)
    for a, b in [(x.double(), w.double()), (x, w.bfloat16())]:
        with pytest.raises(TypeError):
            p_gmm.grouped_matmul(a, b)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _ffn_params(rcfg, biased: bool):
    p = jax.tree_util.tree_map(np.array, RL.init_moe_ffn(jax.random.PRNGKey(3), rcfg,
                                                         jnp.float32))
    if biased:
        p["router"][0, :] = 0.0
        p["router"][0, 0] = 10.0
    return p


def _ref_keep(x, router, cfg, capacity):
    """The reference's dispatch, read from its own routing: for each token
    and choice, whether the assignment is kept (in numpy)."""
    _, experts = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router), cfg.top_k)
    fe = np.asarray(experts).reshape(-1)
    order = np.argsort(fe, kind="stable")
    counts = np.bincount(fe, minlength=cfg.n_experts)
    starts = np.cumsum(counts) - counts
    keep = np.empty(fe.size, bool)
    keep[order] = np.arange(fe.size) - starts[fe[order]] < capacity
    return fe, keep


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("t", [1, 7, 64, 300])
def test_moe_ffn_matches_reference(cfgs, t, biased):
    rcfg, pcfg = cfgs
    p = _ffn_params(rcfg, biased)
    x = np.random.default_rng(t).normal(size=(t, rcfg.d_model)).astype(np.float32)
    if biased:
        x[:, 0] = BIAS
    want = np.asarray(RL.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), rcfg))
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = PL.moe_ffn(torch.from_numpy(x), pp, pcfg)
    np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)

    # the same assignments are dropped
    c = PL.moe_capacity(pcfg, t)
    _, experts = PL.moe_route(torch.from_numpy(x), pp["router"], pcfg.top_k)
    order, _, keep_sorted = PL.moe_dispatch(experts, pcfg.n_experts, c)
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    fe, want_keep = _ref_keep(x, p["router"], rcfg, c)
    assert experts.reshape(-1).tolist() == fe.tolist()
    assert keep.tolist() == want_keep.tolist()
    if biased and t > c:  # every token picks expert 0: t - c of them are dropped
        assert int((~keep).sum()) >= t - c > 0
    if t * pcfg.top_k <= c:
        assert bool(keep.all())


def test_moe_ffn_capacity_argument_drops_nothing(cfgs):
    """``capacity=T`` (the batched decode's) keeps every assignment: the
    output equals the sum over each token's experts computed one by one."""
    rcfg, pcfg = cfgs
    p = {k: torch.from_numpy(v) for k, v in _ffn_params(rcfg, True).items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(12, rcfg.d_model))
                         .astype(np.float32))
    x[:, 0] = BIAS
    got = PL.moe_ffn(x, p, pcfg, capacity=12)
    alone = torch.cat([PL.moe_ffn(x[i:i + 1], p, pcfg) for i in range(12)])
    torch.testing.assert_close(got, alone, **FFN_TOL)
    assert not torch.allclose(PL.moe_ffn(x, p, pcfg), alone, **FFN_TOL)  # capacity 8 drops


@pytest.mark.parametrize("t,biased", [(7, False), (64, True)])
def test_plain_moe_ffn_matches_reference(cfgs, t, biased):
    """The yardstick's one-layer MoE (its own routing, capacity and per-expert
    products) against the reference's, drops included; ``n_tokens=None``
    keeps every assignment, like the engine's ``capacity=T``."""
    rcfg, pcfg = cfgs
    p = _ffn_params(rcfg, biased)
    x = np.random.default_rng(t + 100).normal(size=(t, rcfg.d_model)).astype(np.float32)
    if biased:
        x[:, 0] = BIAS
    want = np.asarray(RL.moe_ffn(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), rcfg))
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = plain.moe_ffn(pcfg, torch.from_numpy(x), pp, t)
    np.testing.assert_allclose(got.numpy(), want, **FFN_TOL)
    torch.testing.assert_close(plain.moe_ffn(pcfg, torch.from_numpy(x), pp, None),
                               PL.moe_ffn(torch.from_numpy(x), pp, pcfg, capacity=t), **FFN_TOL)


# ---------------------------------------------------------------------------
# decode: batched slots against the reference's vmap
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jitted(fn, rcfg):
    return jax.jit(partial(fn, rcfg))


def _prefill_ref(rcfg, rparams, prompt, bucket, s_max):
    """The reference engine's bucketed prefill (repro/serve/engine.py:601-615)."""
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :prompt.size] = prompt
    state = RM.init_decode_state(rcfg, 1, s_max, ring=False)
    logits, state = _jitted(RM.decode_step, rcfg)(rparams, state, jnp.asarray(toks))
    state["len"] = jnp.asarray(prompt.size, jnp.int32)
    return np.asarray(logits)[0, :prompt.size], state


def test_decode_slots_with_a_biased_router_matches_reference_vmap(cfgs, monkeypatch):
    """12 slots all routed to expert 0: the reference decodes each slot alone
    (capacity 8, nothing dropped); a batched dispatch with
    ``moe_capacity(cfg, 12)`` = 8 would drop 4 of them."""
    rcfg, pcfg = cfgs
    rparams, pparams = _params(rcfg, pcfg, biased=True)
    rng = np.random.default_rng(12)
    n, s_max = 12, 32
    prompts = [rng.integers(0, rcfg.vocab, int(k)).astype(np.int32)
               for k in rng.integers(1, 9, n)]
    rs = RM.init_slot_states(rcfg, n, s_max)
    ps = PM.init_slot_states(pcfg, n, s_max, device="cpu")
    for i, prompt in enumerate(prompts):
        _, one = _prefill_ref(rcfg, rparams, prompt, 8, s_max)
        rs = RM.write_slot(rs, i, one)
        one_p = PM.init_decode_state(pcfg, 1, s_max, ring=False, device="cpu")
        toks = np.zeros((1, 8), np.int32)
        toks[0, :prompt.size] = prompt
        _, one_p = PM.decode_step(pcfg, pparams, one_p, torch.from_numpy(toks))
        one_p["len"] = prompt.size
        ps = PM.write_slot(ps, i, one_p)

    ps0 = _copy(ps)
    routed = []
    real_route = PL.moe_route

    def recording(x, router, k):
        gates, experts = real_route(x, router, k)
        routed.append(experts)
        return gates, experts

    monkeypatch.setattr(PL, "moe_route", recording)
    first = np.array([p[-1] for p in prompts], np.int32)
    toks, r_step, want0 = first, _jitted(RM.decode_slots, rcfg), None
    for _ in range(3):
        want, rs = r_step(rparams, rs, jnp.asarray(toks))
        got, ps = PM.decode_slots(pcfg, pparams, ps, torch.from_numpy(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want0 = np.asarray(want) if want0 is None else want0
        toks = np.asarray(want).argmax(-1).astype(np.int32)
    assert len(routed) == 3 * pcfg.n_layers
    assert all(bool((e == 0).any(-1).all()) for e in routed)  # all 12 pick expert 0
    assert PL.moe_capacity(pcfg, n) < n  # so a capacity-8 dispatch drops

    # the test bites: the first step with the reference's per-call capacity
    real_ffn = PL.moe_ffn
    monkeypatch.setattr(PL, "moe_ffn", lambda x, p, cfg, capacity=None: real_ffn(x, p, cfg))
    naive, _ = PM.decode_slots(pcfg, pparams, ps0, torch.from_numpy(first))
    assert np.abs(naive.numpy() - want0).max() > 1e-1


def _copy(states):
    return {"len": states["len"].clone(), "layers": tuple(t.clone() for t in states["layers"])}


# ---------------------------------------------------------------------------
# the plain forward: the engine's dispatch groups and routing
# ---------------------------------------------------------------------------
def _served_ref(rcfg, rparams, prompt, bucket, n_new, s_max=96):
    """The reference engine's path for one request: bucketed prefill, then
    greedy decode one token at a time.  Returns (the tokens the logits are
    for, logits (p_len + n_new - 1, V))."""
    logits, state = _prefill_ref(rcfg, rparams, prompt, bucket, s_max)
    out, seq = [logits], list(prompt)
    step = _jitted(RM.decode_step, rcfg)
    tok = int(logits[-1].argmax())
    for _ in range(n_new - 1):
        seq.append(tok)
        lg, state = step(rparams, state, jnp.asarray([[tok]], jnp.int32))
        out.append(np.asarray(lg)[0])
        tok = int(out[-1][-1].argmax())
    return np.array(seq, np.int32), np.concatenate(out)


def test_plain_forward_with_engine_groups_matches_reference_serving(cfgs):
    """A 50-token prompt in a 64 bucket (capacity 40) with the biased router:
    10 prompt tokens are dropped at expert 0; decoded tokens drop nothing."""
    rcfg, pcfg = cfgs
    rparams, pparams = _params(rcfg, pcfg, biased=True)
    prompt = np.random.default_rng(13).integers(0, rcfg.vocab, 50).astype(np.int32)
    seq, want = _served_ref(rcfg, rparams, prompt, 64, 8)
    cap = plain.capacity(pcfg, 64)
    groups = [(0, 50, 64)] + [(t, t + 1, None) for t in range(50, seq.size)]
    stats = {}
    got = plain.forward(pcfg, pparams, torch.from_numpy(seq), moe_groups=groups, stats=stats)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert cap == 40 and all(int((e[:50] == 0).any(-1).sum()) == 50 for e in stats["experts"])
    # one group of all S tokens (the reference's forward) drops decoded tokens too
    alone = plain.forward(pcfg, pparams, torch.from_numpy(seq))
    assert np.abs(alone.numpy() - want).max() > 1e-1
    with pytest.raises(ValueError, match="cover"):
        plain.forward(pcfg, pparams, torch.from_numpy(seq), moe_groups=groups[:-1])


def test_plain_forward_routing_margin_rule(cfgs, monkeypatch):
    """The engine's routing: its own choice changes nothing; a choice beyond
    ``ROUTER_MARGIN`` of the fp32 k-th logit raises; inside it, it is taken
    and counted, and gates still come from the fp32 logits."""
    rcfg, pcfg = cfgs
    _, pparams = _params(rcfg, pcfg, biased=False)
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, rcfg.vocab, 40)
                            .astype(np.int32))
    stats = {}
    own = plain.forward(pcfg, pparams, toks, stats=stats)
    routing = [e.clone() for e in stats["experts"]]
    again = {}
    assert torch.equal(plain.forward(pcfg, pparams, toks, routing=routing, stats=again), own)
    assert "near_ties" not in again

    # at the position where the least likely expert lies furthest below the
    # k-th, the engine "chose" it in place of the k-th
    logits = stats["router_logits"][0]
    top = torch.topk(logits, pcfg.top_k, dim=-1).values[:, -1]
    low, worst = logits.min(-1)
    i = int((top - low).argmax())
    assert float(top[i] - low[i]) > plain.ROUTER_MARGIN
    forced = [e.clone() for e in routing]
    forced[0][i, -1] = worst[i]
    with pytest.raises(ValueError, match=f"position {i}"):
        plain.forward(pcfg, pparams, toks, routing=forced)
    monkeypatch.setattr(plain, "ROUTER_MARGIN", float(top[i] - low[i]) + 1.0)
    taken = {}
    moved = plain.forward(pcfg, pparams, toks, routing=forced, stats=taken)
    assert taken["near_ties"] == 1 and taken["max_tie_gap"] == pytest.approx(float(top[i] - low[i]))
    assert torch.equal(moved[:i], own[:i]) and not torch.allclose(moved[i], own[i])
