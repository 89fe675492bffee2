"""The cases, fixtures and checks of ``test_torch_sharded_serve.py`` (a
2-rank world) and ``test_torch_sharded_serve_4.py`` (a 4-rank world): the
sharded serving path (``ServingEngine(mesh=)``, ``launch.sharding`` and the
mesh-aware model) in a CPU ``gloo`` world spawned once for each test module
by ``launch.mesh.run_world``, at reduced size in fp32.  A test module sets
``RANKS`` and imports everything from here.

Every rank cuts the same full parameters (the reference's ``init_params``,
carried across with ``params_from_numpy``) with ``param_specs`` and runs the
same calls: a prefill (``decode_step``), three ``decode_slots`` steps, the
greedy decode, and the engine over five prompts.  Rank 0's results come back
and are held against the reference's unsharded ``forward``,
``decode_slots`` and engine (``tests/test_torch_models.py``'s 2e-3, greedy
tokens equal) and against the unsharded port (1e-5; the same MoE drops).
Each world's collectives time out after ``TIMEOUT_S``, so a rank that skips
a collective fails the module instead of hanging it.

Module-level imports load neither jax nor ``repro``: every rank imports
this module to find ``world_cases``.  The name has no ``test_`` prefix, so
pytest collects its checks only where a test module imports them."""
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config as p_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh, run_world, set_mesh
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

torch.set_num_threads(1)
TOL = dict(rtol=2e-3, atol=2e-3)       # tests/test_models.py
PORT_TOL = dict(rtol=1e-5, atol=1e-5)  # the unsharded port
TIMEOUT_S = 60
SLOTS, MAX_LEN = 4, 64
SCFG = dict(batch_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=6)
PROMPTS = [np.array(p, np.int32) for p in
           ([5, 7, 11, 13, 17], [3, 1, 4, 1, 5, 9, 2, 6], [2] * 12, [8], list(range(1, 41)))]
# the last prompt takes the 64-token bucket: 64 tokens over 4 experts at
# capacity 40 drop assignments under the biased router
BIAS = 20.0  # tests/test_torch_moe.py's biased router: capacity drops certainly happen
THREE = 3  # "biased 3": experts that do not divide model = 2 (the TP fallback)

# label -> (arch, variant, world, mesh shape, axes)
CASES = {
    "danube 1x2": ("h2o-danube-3-4b", None, 2, (1, 2), ("data", "model")),
    "danube data 2": ("h2o-danube-3-4b", None, 2, (2,), ("data",)),
    "minicpm odd vocab 1x2": ("minicpm-2b", "odd", 2, (1, 2), ("data", "model")),
    "mixtral ep 1x2": ("mixtral-8x7b", "biased", 2, (1, 2), ("data", "model")),
    "mixtral tp 3 experts 1x2": ("mixtral-8x7b", "biased 3", 2, (1, 2), ("data", "model")),
    "llava 1x2": ("llava-next-mistral-7b", None, 2, (1, 2), ("data", "model")),
    "danube 2x2": ("h2o-danube-3-4b", None, 4, (2, 2), ("data", "model")),
    "qwen kv fallback 1x4": ("qwen1.5-32b", "bias", 4, (1, 4), ("data", "model")),
    "mixtral ep 2x2": ("mixtral-8x7b", "biased", 4, (2, 2), ("data", "model")),
    "danube pod 2x1x2": ("h2o-danube-3-4b", None, 4, (2, 1, 2), ("pod", "data", "model")),
}


def _variant(cfg, variant):
    if variant == "odd":
        return replace(cfg, vocab=511)
    return replace(cfg, n_experts=THREE) if variant == "biased 3" else cfg


def config(label: str):
    arch, variant = CASES[label][:2]
    return _variant(p_config(arch).reduced(), variant)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


STEPS = 3  # decode_slots steps


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _cast(tree, dtype):
    """The tree's leaves in ``dtype``, in place."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _cast(v, dtype)
        else:
            tree[k] = v.to(dtype)
    return tree


def _all_ranks(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _serve(cfg, params, prompts, mesh=None, **scfg):
    """Greedy tokens of ``prompts`` and each request's dropped MoE
    assignments over its prefill."""
    eng = ServingEngine(cfg, params, ServeConfig(**{**SCFG, **scfg}), mesh=mesh)
    drops, cur = {}, [None]
    real_dispatch, real_prefill = PL.moe_dispatch, eng._prefill

    def dispatch(experts, e, c):
        order, dest, keep = real_dispatch(experts, e, c)
        if cur[0] is not None:
            drops[cur[0]] = drops.get(cur[0], 0) + int((~keep).sum())
        return order, dest, keep

    def prefill(h):
        cur[0] = h.rid
        try:
            return real_prefill(h)
        finally:
            cur[0] = None

    eng._prefill, PL.moe_dispatch = prefill, dispatch
    try:
        hs = [eng.submit(p) for p in prompts]
        eng.drain()
    finally:
        PL.moe_dispatch = real_dispatch
    return [h.tokens for h in hs], drops, eng


def _lifecycle(cfg, params, mesh=None):
    """Deadlines and cancellation: request 0 times out at once, request 1
    is cancelled after the first step; the others complete."""
    eng = ServingEngine(cfg, params, ServeConfig(**SCFG), mesh=mesh)
    hs = [eng.submit(PROMPTS[0], timeout_s=0.0)] + [eng.submit(p) for p in PROMPTS[1:4]]
    eng.step()
    hs[1].cancel()
    eng.drain()
    return [(h.state.value, list(h.tokens)) for h in hs]


def run_case(label: str, tree) -> dict:
    """One case on this rank of the current world."""
    cfg = config(label)
    shape, axes = CASES[label][3:]
    mesh = make_mesh(shape, axes, device="cpu")
    full = params_from_numpy(cfg, tree, "cpu")
    specs = SH.param_specs(full, mesh, cfg=cfg)
    local = SH.shard_params(SH.copy_tree(full), specs, mesh)
    out: dict = {"local_bytes": sum(t.numel() * t.element_size() for t in _leaves(local))}
    if cfg.is_moe:
        out["expert_shape"] = tuple(local["layers"][0]["ffn"]["wg"].shape)
    back = SH.gather_to_root(local, specs, mesh)  # the full tree on rank 0
    out["roundtrip"] = back is None or all(torch.equal(a, b)
                                           for a, b in zip(_leaves(back), _leaves(full)))
    n_local, base = SH.slot_layout(SLOTS, mesh)
    with set_mesh(mesh):
        state = PM.init_decode_state(cfg, 2, MAX_LEN, ring=False, device="cpu")
        logits, _ = PM.decode_step(cfg, local, state, torch.from_numpy(_tokens(cfg, (2, 24), 1)))
        out["prefill"] = PM.full_vocab(cfg, logits).numpy()
        states = PM.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
        greedy = PM.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
        out["kv_heads"] = int(states["layers"][0].shape[2])
        steps, picks = [], []
        for k in range(STEPS):
            t = torch.from_numpy(_tokens(cfg, (SLOTS,), 10 + k))[base:base + n_local]
            lg, states = PM.decode_slots(cfg, local, states, t)
            nxt, greedy = PM.decode_slots_greedy(cfg, local, greedy, t)
            steps.append((base, PM.full_vocab(cfg, lg).numpy()))
            picks.append((base, nxt.numpy()))
    # every rank's slots, in slot order (a slot's model ranks agree)
    out["decode"] = [np.concatenate([a for _, a in sorted(dict(r).items())])
                     for r in zip(*[list(map(tuple, x)) for x in _all_ranks(steps)])]
    out["greedy"] = [np.concatenate([a for _, a in sorted(dict(r).items())])
                     for r in zip(*[list(map(tuple, x)) for x in _all_ranks(picks)])]
    tokens, drops, eng = _serve(cfg, SH.copy_tree(full), PROMPTS, mesh=mesh)
    out["engine_ranks"] = _all_ranks(tokens)
    out["engine_local_slots"] = (eng._n_local, eng._base)
    merged: dict = {}
    for d in _all_ranks(drops):
        merged.update(d)
    out["drops"] = merged
    if label == "danube 1x2":
        out["temperature"] = _all_ranks(_serve(cfg, SH.copy_tree(full), PROMPTS, mesh=mesh,
                                               temperature=0.7, seed=3)[0])
        out["lifecycle"] = _all_ranks(_lifecycle(cfg, SH.copy_tree(full), mesh=mesh))
        bf16 = replace(cfg, dtype="bfloat16")  # bf16 gathers and fp32 sums of bf16 partials
        eng = ServingEngine(bf16, _cast(SH.copy_tree(full), torch.bfloat16), ServeConfig(**SCFG),
                            mesh=mesh)
        hs = [eng.submit(p) for p in PROMPTS]
        eng.drain()
        out["bf16"] = _all_ranks([(h.state.value, list(h.tokens)) for h in hs])
    return out


def world_cases(trees: dict) -> dict:
    n = dist.get_world_size()
    return {label: run_case(label, trees[label]) for label in CASES if CASES[label][2] == n}


# ---------------------------------------------------------------------------
# the parent: reference trees, worlds, unsharded references
# ---------------------------------------------------------------------------
def reference_tree(label: str):
    import jax

    from repro.configs import get_config as r_config
    from repro.models import model as RM

    arch, variant = CASES[label][:2]
    rcfg = _variant(r_config(arch).reduced(), variant)
    tree = jax.tree_util.tree_map(np.array, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    if variant in ("biased", "biased 3"):
        tree["embed"][:, 0] = BIAS
        router = tree["layers"]["ffn"]["router"]
        router[:, 0, :] = 0.0
        router[:, 0, 0] = 10.0
    if variant == "bias":  # nonzero q/k/v biases
        rng = np.random.default_rng(7)
        for b in ("bq", "bk", "bv"):
            m = tree["layers"]["mixer"]
            m[b] = rng.normal(0, 0.1, m[b].shape).astype(np.float32)
    return rcfg, tree


def labels(n: int) -> list[str]:
    """The cases of an ``n``-rank world."""
    return [label for label in CASES if CASES[label][2] == n]


@pytest.fixture(scope="module")
def trees(request):
    return {label: reference_tree(label) for label in labels(request.module.RANKS)}


@pytest.fixture(scope="module")
def world(request, trees):
    """Rank 0's results of every case of the module's world."""
    return run_world(request.module.RANKS, world_cases,
                     ({k: t for k, (_, t) in trees.items()},), timeout_s=TIMEOUT_S, threads=1)


@pytest.fixture
def case(request, world):
    return request.param, world[request.param]


def pytest_generate_tests(metafunc):
    """``case`` over the module's labels; ``moe_label`` over its MoE ones."""
    n = metafunc.module.RANKS
    if "case" in metafunc.fixturenames:
        metafunc.parametrize("case", labels(n), indirect=True)
    if "moe_label" in metafunc.fixturenames:
        metafunc.parametrize("moe_label", [k for k in labels(n)
                                           if CASES[k][1] in ("biased", "biased 3")])


@pytest.fixture(scope="module")
def unsharded(trees):
    """The reference's forward, decode_slots and engine, and the unsharded
    port's, for every case."""
    import jax.numpy as jnp

    from repro.models import model as RM
    from repro.serve import ServeConfig as RServeConfig
    from repro.serve import ServingEngine as RServingEngine

    out = {}
    for label, (rcfg, tree) in trees.items():
        cfg = config(label)
        rparams = _jnp_tree(tree)
        pparams = params_from_numpy(cfg, tree, "cpu")
        toks = _tokens(cfg, (2, 24), 1)
        batch = {"tokens": jnp.asarray(toks)}
        if rcfg.family == "vlm":  # text only, as the engine serves it
            batch["embeds"] = jnp.zeros((2, 0, rcfg.d_model), jnp.float32)
        rec = {"r_prefill": np.asarray(RM.forward(rcfg, rparams, batch))}
        state = PM.init_decode_state(cfg, 2, MAX_LEN, ring=False, device="cpu")
        rec["p_prefill"] = PM.decode_step(cfg, pparams, state, torch.from_numpy(toks))[0].numpy()
        rstates = RM.init_slot_states(rcfg, SLOTS, MAX_LEN)
        pstates = PM.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
        greedy = PM.init_slot_states(cfg, SLOTS, MAX_LEN, device="cpu")
        rec["r_decode"], rec["p_decode"], rec["p_greedy"] = [], [], []
        for k in range(STEPS):
            t = _tokens(cfg, (SLOTS,), 10 + k)
            lg, rstates = RM.decode_slots(rcfg, rparams, rstates, jnp.asarray(t))
            rec["r_decode"].append(np.asarray(lg))
            lg, pstates = PM.decode_slots(cfg, pparams, pstates, torch.from_numpy(t))
            rec["p_decode"].append(lg.numpy())
            nxt, greedy = PM.decode_slots_greedy(cfg, pparams, greedy, torch.from_numpy(t))
            rec["p_greedy"].append(nxt.numpy())
        eng = RServingEngine(rcfg, rparams, RServeConfig(**SCFG))
        hs = [eng.submit(p) for p in PROMPTS]
        eng.drain()
        rec["r_engine"] = [h.tokens for h in hs]
        rec["p_engine"], rec["p_drops"], _ = _serve(cfg, params_from_numpy(cfg, tree, "cpu"),
                                                    PROMPTS)
        if label == "danube 1x2":
            rec["p_temperature"] = _serve(cfg, params_from_numpy(cfg, tree, "cpu"), PROMPTS,
                                          temperature=0.7, seed=3)[0]
            rec["p_lifecycle"] = _lifecycle(cfg, params_from_numpy(cfg, tree, "cpu"))
        out[label] = rec
    return out


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_params_round_trip_and_shrink(case, trees):
    label, case = case
    full = sum(a.nbytes for a in _leaves_np(trees[label][1]))
    assert case["roundtrip"]
    shape, axes = CASES[label][3:]
    if dict(zip(axes, shape)).get("model", 1) > 1:  # the rank holds part of the model
        assert case["local_bytes"] < 0.75 * full, (case["local_bytes"], full)
    else:
        assert case["local_bytes"] == full


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_np(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_np(v)]
    return [tree]


def test_prefill_matches_reference_and_unsharded(case, unsharded):
    label, case = case
    u = unsharded[label]
    np.testing.assert_allclose(case["prefill"], u["r_prefill"], **TOL)
    np.testing.assert_allclose(case["prefill"], u["p_prefill"], **PORT_TOL)


def test_decode_slots_match_reference_and_unsharded(case, unsharded):
    label, case = case
    u = unsharded[label]
    for k in range(STEPS):
        np.testing.assert_allclose(case["decode"][k], u["r_decode"][k], **TOL, err_msg=str(k))
        np.testing.assert_allclose(case["decode"][k], u["p_decode"][k], **PORT_TOL,
                                   err_msg=str(k))
        np.testing.assert_array_equal(case["greedy"][k], u["p_greedy"][k], err_msg=str(k))


def test_engine_greedy_tokens_equal_reference_on_every_rank(case, unsharded):
    label, case = case
    ranks = case["engine_ranks"]
    assert all(r == ranks[0] for r in ranks)
    assert ranks[0] == unsharded[label]["r_engine"] == unsharded[label]["p_engine"]


def test_moe_drops_equal_unsharded(moe_label, world, unsharded):
    case = world[moe_label]
    assert case["drops"] == unsharded[moe_label]["p_drops"]
    assert sum(case["drops"].values()) > 0  # the biased router drops


EXPERT_SHAPES = {  # a rank's (E, D, F) of wg: E cut (EP), else F (the TP fallback)
    "mixtral ep 1x2": (2, 128, 256), "mixtral ep 2x2": (2, 128, 256),
    "mixtral tp 3 experts 1x2": (3, 128, 128)}


def test_moe_experts_cut(moe_label, world):
    assert world[moe_label]["expert_shape"] == EXPERT_SHAPES[moe_label]


LAYOUTS = {  # (this rank's slots and first slot, KV heads its cache holds) on rank 0
    "danube 1x2": ((4, 0), 1), "danube data 2": ((2, 0), 2),
    "minicpm odd vocab 1x2": ((4, 0), 2), "mixtral ep 1x2": ((4, 0), 1),
    "mixtral tp 3 experts 1x2": ((4, 0), 1),
    "llava 1x2": ((4, 0), 1), "danube 2x2": ((2, 0), 1),
    "qwen kv fallback 1x4": ((4, 0), 1), "mixtral ep 2x2": ((2, 0), 1),
    "danube pod 2x1x2": ((2, 0), 1)}


def test_layouts(case):
    """Slots over the DP axes, KV heads over model or kept per GQA group."""
    label, case = case
    assert (case["engine_local_slots"], case["kv_heads"]) == LAYOUTS[label]


def check_deadlines_cancel_sampling(world, unsharded):
    """Deadlines, cancellation and temperature sampling decided alike on
    every rank, as the unsharded engine decides them."""
    case, u = world["danube 1x2"], unsharded["danube 1x2"]
    assert all(r == case["temperature"][0] for r in case["temperature"])
    assert case["temperature"][0] == u["p_temperature"]
    assert all(r == case["lifecycle"][0] for r in case["lifecycle"])
    assert case["lifecycle"][0] == u["p_lifecycle"]
    assert [s for s, _ in case["lifecycle"][0]] == ["timed_out", "cancelled", "completed",
                                                    "completed"]
    assert all(r == case["bf16"][0] for r in case["bf16"])
    assert [(s, len(t)) for s, t in case["bf16"][0]] == [("completed", 6)] * len(PROMPTS)
