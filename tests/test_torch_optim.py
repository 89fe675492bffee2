"""The port's AdamW, schedules and gradient codecs (``repro_torch.optim``)
against the reference's (``repro.optim``) on the CPU.

Inputs come from numpy seeds and go to both.  Tolerances: the schedule and
fp32 updates within 1e-6 relative (both compute in float32; the order of a
few operations differs), bf16 parameters within one bf16 unit in the last
place (an fp32 value a rounding away from a bf16 boundary may round either
way), int8 codes equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R
from repro.optim import compression as RC
from repro_torch.optim import adamw as P
from repro_torch.optim import compression as PC

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-8


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 6), (3, 40)])
def test_lr_schedule_matches_reference(schedule, warmup, total):
    cfg_r = R.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total, schedule=schedule)
    cfg_p = P.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total, schedule=schedule)
    got = [P.lr_at(cfg_p, s) for s in range(total + 2)]
    want = [float(R.lr_at(cfg_r, s)) for s in range(total + 2)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert P.lr_at(cfg_p, torch.tensor(3, dtype=torch.int32)) == got[3]


def test_wsd_schedule_shape():
    cfg = P.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule="wsd")
    lrs = [P.lr_at(cfg, s) for s in range(100)]
    assert lrs[0] < 0.2 and abs(lrs[50] - 1.0) < 1e-5 and lrs[99] < lrs[89]


def _tree(rng, dtype):
    shapes = {"w": (6, 5), "b": (5,), "layers": {"a": (3, 4), "g": (4,)}}

    def make(s):
        return {k: make(v) for k, v in s.items()} if isinstance(s, dict) else \
            rng.normal(size=s).astype(np.float32)

    arrays = make(shapes)
    to_p = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    to_r = lambda a: jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)  # noqa: E731
    return jax.tree_util.tree_map(to_r, arrays), P.tree_map(to_p, arrays), arrays


def _assert_tree_close(got, want, bf16=False):
    for g, w in zip(P.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = _np(g), np.asarray(w, np.float32)
        if bf16:  # within one bf16 ulp
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert (np.abs(g - w) <= ulp).all()
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL * 10, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["wsd", "cosine"])
def test_three_adamw_steps_match_reference(dtype, schedule):
    rng = np.random.default_rng(3)
    r_params, p_params, _ = _tree(rng, dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule, grad_clip=1.0)
    r_cfg, p_cfg = R.AdamWConfig(**kw), P.AdamWConfig(**kw)
    r_state, p_state = R.adamw_init(r_params), P.adamw_init(p_params)
    assert p_state["m"]["w"].dtype == torch.float32 and int(p_state["step"]) == 0
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.3, r_params)
        r_grads = jax.tree_util.tree_map(lambda g, p: jnp.asarray(g, p.dtype), grads, r_params)
        p_grads = P.tree_map(lambda g, p: torch.from_numpy(g).to(p.dtype),
                             jax.tree_util.tree_map(np.asarray, grads), p_params)
        r_params, r_state, r_m = R.adamw_update(r_cfg, r_params, r_grads, r_state)
        p_params, p_state, p_m = P.adamw_update(p_cfg, p_params, p_grads, p_state)
        assert int(p_state["step"]) == int(r_state["step"]) == step + 1
        np.testing.assert_allclose(float(p_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
        assert p_m["lr"] == pytest.approx(float(r_m["lr"]), rel=RTOL)
        assert not bool(p_m["skipped"])
        _assert_tree_close(p_params, r_params, bf16=dtype == torch.bfloat16)
        assert all(p.dtype == dtype for p in P.tree_leaves(p_params))
        _assert_tree_close(p_state["m"], r_state["m"])
        _assert_tree_close(p_state["v"], r_state["v"])


def test_nan_grads_skip_the_step_and_advance_the_counter():
    rng = np.random.default_rng(4)
    r_params, p_params, arrays = _tree(rng, torch.float32)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    r_state, p_state = R.adamw_init(r_params), P.adamw_init(p_params)
    good = jax.tree_util.tree_map(lambda p: np.ones(p.shape, np.float32), r_params)
    r_params, r_state, _ = R.adamw_update(R.AdamWConfig(**kw), r_params,
                                          jax.tree_util.tree_map(jnp.asarray, good), r_state)
    p_params, p_state, _ = P.adamw_update(P.AdamWConfig(**kw), p_params,
                                          P.tree_map(torch.from_numpy, good), p_state)
    bad = jax.tree_util.tree_map(lambda g: np.full_like(g, np.nan), good)
    before = [t.clone() for t in P.tree_leaves(p_params)]
    r_params, r_state, r_m = R.adamw_update(R.AdamWConfig(**kw), r_params,
                                            jax.tree_util.tree_map(jnp.asarray, bad), r_state)
    p_params, p_state, p_m = P.adamw_update(P.AdamWConfig(**kw), p_params,
                                            P.tree_map(torch.from_numpy, bad), p_state)
    assert bool(p_m["skipped"]) and bool(r_m["skipped"])
    assert int(p_state["step"]) == int(r_state["step"]) == 2
    for a, b in zip(before, P.tree_leaves(p_params)):
        assert torch.equal(a, b)
    _assert_tree_close(p_state["m"], r_state["m"])  # the moments decay as for a zero gradient
    _assert_tree_close(p_state["v"], r_state["v"])


def test_grad_clip_reports_the_norm_before_clipping():
    p = {"w": torch.zeros(4)}
    st = P.adamw_init(p)
    _, _, m = P.adamw_update(P.AdamWConfig(grad_clip=1.0), p, {"w": torch.full((4,), 100.0)},
                             st)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    r = {"w": jnp.zeros(4)}
    r_new, _, _ = R.adamw_update(R.AdamWConfig(grad_clip=1.0), r, {"w": jnp.full((4,), 100.0)},
                                 R.adamw_init(r))
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(r_new["w"]), rtol=RTOL, atol=ATOL)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    r_tree, p_tree, _ = _tree(rng, torch.float32)
    np.testing.assert_allclose(float(P.global_norm(p_tree)), float(R.global_norm(r_tree)),
                               rtol=1e-6)


def test_bf16_compression_matches_reference():
    g = np.linspace(-1, 1, 64).astype(np.float32)
    comp, _, res = PC.compress_grads({"w": torch.from_numpy(g)}, None, "bf16")
    want, _, _ = RC.compress_grads({"w": jnp.asarray(g)}, None, "bf16")
    assert comp["w"].dtype == torch.bfloat16 and res is None
    np.testing.assert_array_equal(comp["w"].float().numpy(), np.asarray(want["w"], np.float32))
    back = PC.decompress_grads(comp, None, "bf16")
    assert back["w"].dtype == torch.float32
    assert PC.compress_grads({"w": torch.from_numpy(g)}, None, "none")[0]["w"] is not None


def test_int8_compression_carries_the_residual_over_two_rounds():
    rng = np.random.default_rng(6)
    rounds = [{"w": rng.normal(size=(128,)).astype(np.float32),
               "l": {"a": rng.normal(size=(4, 9)).astype(np.float32) * 1e-3}} for _ in range(2)]
    p_res = r_res = None
    for g in rounds:
        p_comp, p_scales, p_res = PC.compress_grads(P.tree_map(torch.from_numpy, g), p_res,
                                                    "int8")
        r_comp, r_scales, r_res = RC.compress_grads(jax.tree_util.tree_map(jnp.asarray, g),
                                                    r_res, "int8")
        for a, b in zip(P.tree_leaves(p_comp), jax.tree_util.tree_leaves(r_comp)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_tree_close(p_scales, r_scales)
        _assert_tree_close(p_res, r_res)
        deco = PC.decompress_grads(p_comp, p_scales, "int8")
        want = RC.decompress_grads(r_comp, r_scales, "int8")
        _assert_tree_close(deco, want)
    # rounding to the nearest code leaves at most half a step behind
    assert float(p_res["w"].abs().max()) <= float(p_scales["w"]) / 2 * (1 + 1e-6)
    with pytest.raises(ValueError):
        PC.compress_grads({"w": torch.zeros(2)}, None, "fp4")
