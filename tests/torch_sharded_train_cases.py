"""The cases, fixtures and checks of ``test_torch_sharded_train.py`` (a
2-rank world) and ``test_torch_sharded_train_4.py`` (a 4-rank world): sharded
training (``Trainer(mesh=)``, ``train_loop.make_grads``, the collectives of
``launch.sharding`` under autograd, ``optim.adamw.global_norm`` under a
mesh) in a CPU ``gloo`` world spawned once for each test module by
``launch.mesh.run_world``, at reduced size in fp32.  A test module sets
``RANKS`` and imports everything from here.

Every rank cuts the same full parameters (the reference's ``init_params``,
carried across with ``params_from_numpy``) with ``param_specs`` and takes
the loss and gradient of the same batch (``make_grads``: each data-parallel
rank its rows, the gradients summed over the data-parallel axes).  Rank 0
returns the gathered gradient, which is held against the reference's
``jax.value_and_grad`` of ``loss_fn`` (tests/test_torch_train.py's
tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of its
tensor's largest value) and against the unsharded port (1e-5).  Then three
``Trainer`` steps of two microbatches with a ``grad_clip`` small enough
that clipping acts, held against the unsharded ``Trainer`` (parameters
within 1e-5).  The cases of ``CHECKS`` also poison one rank's gradient
shard (every rank must skip the step), run ``run_resilient(5, fail_at=3)``
(bit-identical to an uninterrupted run, shard shapes restored) and leave a
checkpoint the reference's ``CheckpointManager`` restores.  Each world's
collectives time out after ``TIMEOUT_S``, so a rank that skips a collective
fails the module instead of hanging it.

Module-level imports load neither jax nor ``repro``: every rank imports
this module to find ``world_cases``.  The name has no ``test_`` prefix, so
pytest collects its checks only where a test module imports them."""
import functools
import os
import pickle
import threading
import time
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config as p_config
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh, run_world, set_mesh
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import global_norm, tree_leaves, tree_unflatten
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import train_loop as PT

torch.set_num_threads(1)
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5  # tests/test_torch_train.py
PORT_TOL = 1e-5                  # the unsharded port
TIMEOUT_S = 60
S, B = 16, 4
BIAS = 20.0  # tests/test_torch_moe.py's biased router: capacity drops certainly happen
THREE = 3  # "biased 3": experts that do not divide model = 2 (the TP fallback)
OCFG = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=1e-3)
STEPS = 3

# label -> (arch, variant, world, mesh shape, axes)
CASES = {
    "minicpm 1x2": ("minicpm-2b", None, 2, (1, 2), ("data", "model")),
    "minicpm data 2": ("minicpm-2b", None, 2, (2,), ("data",)),
    "minicpm odd vocab 1x2": ("minicpm-2b", "odd", 2, (1, 2), ("data", "model")),
    "llava 1x2": ("llava-next-mistral-7b", None, 2, (1, 2), ("data", "model")),
    "danube 2x2 block remat": ("h2o-danube-3-4b", "block", 4, (2, 2), ("data", "model")),
    "danube pod 2x1x2": ("h2o-danube-3-4b", None, 4, (2, 1, 2), ("pod", "data", "model")),
    "qwen kv fallback 1x4": ("qwen1.5-32b", "bias", 4, (1, 4), ("data", "model")),
    "mixtral ep 2x2": ("mixtral-8x7b", "biased", 4, (2, 2), ("data", "model")),
    "mixtral tp 3 experts 2x2": ("mixtral-8x7b", "biased 3", 4, (2, 2), ("data", "model")),
}
# the cases that also skip a poisoned step, resume and leave a checkpoint
CHECKS = ("minicpm 1x2", "mixtral ep 2x2")


def _variant(cfg, variant):
    if variant == "odd":
        return replace(cfg, vocab=511)
    if variant == "block":
        return replace(cfg, remat="block")
    if variant == "biased":
        return replace(cfg, remat="block_save_moe")
    return replace(cfg, n_experts=THREE) if variant == "biased 3" else cfg


def config(label: str):
    arch, variant = CASES[label][:2]
    return _variant(p_config(arch).reduced(), variant)


def batch_of(cfg, step: int = 1) -> dict:
    """The gradient checks' batch (the whole batch, on every rank)."""
    batch = LMDataPipeline(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                      seed=31)).batch_at(step)
    if cfg.frontend is not None:
        rng = np.random.default_rng(310 + step)
        batch["embeds"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    return batch


def dcfg_of(cfg) -> DataConfig:
    return DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab, seed=32)


def tcfg_of(ckpt_dir, **kw) -> TrainerConfig:
    return TrainerConfig(ckpt_dir=str(ckpt_dir), **{"accum_steps": 2, "ckpt_every": 100, **kw})


def _trainable(tree):
    for t in tree_leaves(tree):
        t.requires_grad_(True)
    return tree


def _np(tree) -> list:
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def _full(tree, specs, mesh) -> list | None:
    """The full tree's leaves as numpy on rank 0 (None elsewhere)."""
    full = SH.gather_to_root(tree, specs, mesh)
    return None if full is None else _np(full)


def _all_ranks(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _drops(fn):
    """(fn(), this rank's dropped assignments over it)."""
    n, real = [0], PL.moe_dispatch

    def dispatch(*args):
        order, dest, keep = real(*args)
        n[0] += int((~keep).sum())
        return order, dest, keep

    PL.moe_dispatch = dispatch
    try:
        return fn(), n[0]
    finally:
        PL.moe_dispatch = real


def _train(tr, cfg, steps: int) -> list:
    """(loss, skipped) of ``steps`` steps: ``Trainer.run``, or for the
    ``vlm`` family (whose batches carry patch embeddings the data pipeline
    does not make) its step function on ``batch_of``'s batches."""
    if cfg.frontend is None:
        tr.run(steps)
        return [(h["loss"], h["skipped"]) for h in tr.history]
    out = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 10 + i).items()}
        tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state, batch)
        out.append((float(m["loss"]), bool(m["skipped"])))
    return out


def _gathered(trainer) -> list | None:
    return _full(trainer.params, trainer._ctx.specs, trainer.mesh)


def _trainer_checks(label, cfg, mesh, tmp: Path) -> dict:
    """A poisoned gradient shard on the last rank; ``run_resilient`` against
    an uninterrupted run; the checkpoint it leaves."""
    out = {}
    real = PT.adamw_update

    def poisoned(ocfg, params, grads, state, **kw):
        if dist.get_rank() == dist.get_world_size() - 1:
            leaf, spec = next((g, s) for g, s in zip(tree_leaves(grads),
                                                     SH.leaf_specs(grads, kw["specs"]))
                              if SH.cut_axes(s, mesh))
            leaf.view(-1)[0] = float("inf")
        return real(ocfg, params, grads, state, **kw)

    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "poison"), mesh=mesh, device="cpu")
    before = [t.detach().clone() for t in tree_leaves(tr.params)]
    PT.adamw_update = poisoned
    try:
        tr.run(1)
    finally:
        PT.adamw_update = real
    out["poison_skipped"] = _all_ranks(tr.history[-1]["skipped"])
    out["poison_unchanged"] = _all_ranks(all(torch.equal(a, b) for a, b in
                                             zip(before, tree_leaves(tr.params))))
    del tr
    plain = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "plain"), mesh=mesh, device="cpu")
    plain.run(5)
    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "resilient", ckpt_every=2), mesh=mesh,
                 device="cpu")
    shapes = [tuple(t.shape) for t in tree_leaves(tr.params)]
    tr.run_resilient(5, fail_at=3)
    out["resilient_losses"] = ([h["loss"] for h in tr.history],
                               [h["loss"] for h in plain.history])
    out["resilient_equal"] = _all_ranks(
        all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params) + tree_leaves(tr.opt_state),
                                              tree_leaves(plain.params)
                                              + tree_leaves(plain.opt_state))))
    fresh = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "resilient", ckpt_every=2),
                    mesh=mesh, device="cpu")
    out["restored"] = (fresh.try_restore(), fresh.step)
    out["restored_shapes"] = _all_ranks(
        [tuple(t.shape) for t in tree_leaves(fresh.params)] == shapes
        and all([tuple(t.shape) for t in tree_leaves(fresh.opt_state[k])] == shapes
                for k in ("m", "v")))
    del fresh, tr, plain
    # a checkpoint at step 2 and the state it was saved from
    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "ckpt", ckpt_every=2), mesh=mesh,
                 device="cpu")
    tr.run(2)
    specs = tr._ctx.specs
    out["ckpt_dir"] = str(tmp / "ckpt")
    out["ckpt_state"] = (_full(tr.params, specs, mesh),
                         {k: _full(tr.opt_state[k], specs, mesh) for k in ("m", "v")},
                         int(tr.opt_state["step"]))
    return out


def run_case(label: str, tree, tmp: str) -> dict:
    """One case on this rank of the current world."""
    cfg = config(label)
    shape, axes = CASES[label][3:]
    tmp = Path(tmp) / label.replace(" ", "_")
    t0 = time.perf_counter()
    mesh = make_mesh(shape, axes, device="cpu")
    out: dict = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        full = params_from_numpy(cfg, tree, "cpu")
        specs = SH.param_specs(full, mesh, cfg=cfg)
        local = _trainable(SH.shard_params(SH.copy_tree(full), specs, mesh))
        out["local_shapes"] = [tuple(t.shape) for t in tree_leaves(local)]
        batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
        (loss, grads), drops = _drops(lambda: PT.make_grads(cfg, 1, mesh)(local, batch))
        gtree = tree_unflatten(local, list(grads))
        out["loss"] = float(loss)
        counted = "model" not in axes or mesh.local_rank("model") == 0  # a model line's once
        out["drops"] = sum(_all_ranks(drops if counted else 0))
        out["norm"] = float(global_norm(gtree, mesh, specs))
        out["grads"] = _full(gtree, specs, mesh)
        out["grads_alike"] = _all_ranks([float(g.double().sum()) for g in tree_leaves(gtree)])
        del grads, gtree
        tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "steps"), mesh=mesh, device="cpu")
        steps = _train(tr, cfg, STEPS)
        out["train_losses"] = _all_ranks([x for x, _ in steps])
        out["train_skipped"] = [x for _, x in steps]
        out["train_params"] = _gathered(tr)
        del tr
        if label in CHECKS:
            out.update(_trainer_checks(label, cfg, mesh, tmp))
        if label == "minicpm 1x2":
            out["ffn"] = ffn_input_gradient(cfg)
    out["warnings"] = sorted({str(w.message)[:200] for w in caught})
    out["seconds"] = time.perf_counter() - t0
    return out


def ffn_input_gradient(cfg) -> dict:
    """``dense_ffn`` of layer 0's weights on this rank's shards, the input
    gradient of a seeded output gradient; and the same with *f*'s backward
    all-reduce taken out (the input gradient as it was before sharded
    training)."""
    rng = np.random.default_rng(5)
    full = {k: torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32))
            for k, s in (("wg", (cfg.d_model, cfg.d_ff)), ("wu", (cfg.d_model, cfg.d_ff)),
                         ("wd", (cfg.d_ff, cfg.d_model)))}
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    specs = SH.param_specs({"layers": [{"ffn": full}]}, mesh, cfg=cfg)["layers"][0]["ffn"]
    local = SH.shard_params(dict(full), specs, mesh)
    out = {}
    for name, entry in (("sharded", SH.column_entry), ("without f", lambda x, g: x)):
        real, SH.column_entry = SH.column_entry, entry
        try:
            xi = x.clone().requires_grad_()
            with set_mesh(mesh):
                y = PL.dense_ffn(xi, local, cfg)
            out[name] = (y.detach().numpy(), torch.autograd.grad(y, xi, dy)[0].numpy())
        finally:
            SH.column_entry = real
    xi = x.clone().requires_grad_()
    y = PL.dense_ffn(xi, full, cfg)
    out["unsharded"] = (y.detach().numpy(), torch.autograd.grad(y, xi, dy)[0].numpy())
    return out


def unsharded_port(label: str, tree, tmp: Path) -> dict:
    """The unsharded port's loss, gradient, drops and norm on the case's
    batch, and its three Trainer steps."""
    cfg = config(label)
    params = _trainable(params_from_numpy(cfg, tree, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in batch_of(cfg).items()}
    (loss, grads), drops = _drops(lambda: PT.make_grads(cfg, 1)(params, batch))
    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(tmp / "unsharded"), device="cpu")
    steps = _train(tr, cfg, STEPS)
    return dict(loss=float(loss), grads=[g.numpy() for g in grads], drops=drops,
                norm=float(global_norm(tree_unflatten(params, list(grads)))),
                train_losses=[x for x, _ in steps], train_params=_np(tr.params))


def world_cases(trees_file: str, tmp: str) -> dict:
    """Every case of this world's size on every rank; then the unsharded
    port's references, the cases dealt out over the ranks.  The reference
    trees arrive in ``trees_file`` while the ranks start."""
    n, rank = dist.get_world_size(), dist.get_rank()
    path = Path(trees_file)
    while not path.exists():
        if path.with_suffix(".err").exists():
            raise RuntimeError("the parent made no reference trees")
        time.sleep(0.05)
    with open(path, "rb") as f:
        trees = pickle.load(f)
    mine = [label for label in CASES if CASES[label][2] == n]
    cases = {label: run_case(label, trees[label], tmp) for label in mine}
    refs = {label: unsharded_port(label, trees[label], Path(tmp) / label.replace(" ", "_"))
            for label in mine[rank::n]}
    return {"cases": cases, "unsharded": {k: v for part in _all_ranks(refs)
                                          for k, v in part.items()}}


# ---------------------------------------------------------------------------
# the parent: reference trees, worlds, unsharded references
# ---------------------------------------------------------------------------
def reference_tree(label: str):
    """(the reference's config, its ``init_params`` as numpy) of a case; the
    cases that differ only in the port's remat share one."""
    arch, variant = CASES[label][:2]
    return _reference_tree(arch, None if variant in ("block",) else variant)


@functools.cache
def _reference_tree(arch: str, variant):
    import jax

    from repro.configs import get_config as r_config
    from repro.models import model as RM

    rcfg = r_config(arch).reduced()
    if variant == "odd":
        rcfg = replace(rcfg, vocab=511)
    if variant == "biased 3":
        rcfg = replace(rcfg, n_experts=THREE)
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
def runs(request, tmp_path_factory):
    """(rank 0's results of every case of the module's world, the
    references): the world starts on a thread of its own while this process
    makes the reference trees (handed to the ranks through a file) and the
    reference's gradients."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    trees_file = tmp / "trees.pkl"
    box: dict = {}

    def world_run():
        try:
            box["world"] = run_world(request.module.RANKS, world_cases,
                                     (str(trees_file), str(tmp)), timeout_s=TIMEOUT_S,
                                     threads=1)
        except BaseException as e:  # noqa: BLE001 — raised below, in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world_run)
    thread.start()
    try:
        try:
            trees = {label: reference_tree(label) for label in labels(request.module.RANKS)}
            with open(tmp / "trees.part", "wb") as f:
                pickle.dump({k: t for k, (_, t) in trees.items()}, f)
            os.replace(tmp / "trees.part", trees_file)
        finally:
            if not trees_file.exists():  # the ranks stop waiting
                trees_file.with_suffix(".err").touch()
        refs = reference_gradients(trees)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    world = box["world"]
    for label, u in world["unsharded"].items():
        refs[label].update(u)
    return world["cases"], refs


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.fixture(scope="module")
def unsharded(runs):
    return runs[1]


@pytest.fixture
def case(request, world):
    return request.param, world[request.param]


def pytest_generate_tests(metafunc):
    """``case`` over the module's labels; ``check_label`` over its ``CHECKS``."""
    n = metafunc.module.RANKS
    if "case" in metafunc.fixturenames:
        metafunc.parametrize("case", labels(n), indirect=True)
    if "check_label" in metafunc.fixturenames:
        metafunc.parametrize("check_label", [k for k in labels(n) if k in CHECKS])


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def reference_layout(cfg, leaves: list) -> list:
    """The port's leaves (``tree_leaves`` of its per-layer tree) as the
    reference's: layers stacked, in the reference's leaf order."""
    import jax

    from repro_torch.models import model as PM

    tree = tree_unflatten(PM.init_params(cfg, torch.Generator().manual_seed(0)), leaves)
    out = {k: (_stack(v) if isinstance(v, list) else v) for k, v in tree.items()}
    return jax.tree_util.tree_leaves(out)


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def reference_gradients(trees) -> dict:
    """The reference's loss and gradient on every case's batch."""
    import jax
    import jax.numpy as jnp

    from repro.train import train_loop as RT

    out, done = {}, {}
    for label, (rcfg, tree) in trees.items():
        key = id(tree)  # cases sharing a tree share its reference gradient
        if key not in done:
            jb = {k: jnp.asarray(v) for k, v in batch_of(config(label)).items()}
            rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: RT.loss_fn(rcfg, p, jb)))(
                jax.tree_util.tree_map(jnp.asarray, tree))
            done[key] = dict(r_loss=float(rloss),
                             r_grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(rgrads)])
        out[label] = dict(done[key])
    return out


def test_loss_and_gradient_match_reference_and_unsharded(case, unsharded):
    label, case = case
    u, cfg = unsharded[label], config(label)
    assert case["loss"] == pytest.approx(u["r_loss"], rel=LOSS_TOL)
    assert case["loss"] == pytest.approx(u["loss"], rel=PORT_TOL)
    got = reference_layout(cfg, case["grads"])
    assert len(got) == len(u["r_grads"])
    for i, (g, w) in enumerate(zip(got, u["r_grads"])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert _scaled_err(g, w) <= GRAD_TOL, (label, "reference", i, _scaled_err(g, w))
    for i, (g, w) in enumerate(zip(got, reference_layout(cfg, u["grads"]))):
        assert _scaled_err(g, w) <= PORT_TOL, (label, "unsharded", i, _scaled_err(g, w))


def test_global_norm_is_the_whole_models(case, unsharded):
    label, case = case
    assert case["norm"] == pytest.approx(unsharded[label]["norm"], rel=PORT_TOL)


def test_replicas_hold_one_gradient(case):
    """The data-parallel all-reduce gives the ranks of one model coordinate
    the same gradient."""
    label, case = case
    shape, axes = CASES[label][3:]
    ranks = case["grads_alike"]
    coord = [np.unravel_index(r, shape)[axes.index("model")] if "model" in axes else 0
             for r in range(len(ranks))]
    for r in range(len(ranks)):
        first = coord.index(coord[r])
        assert ranks[r] == ranks[first], (label, r, first)


def test_moe_drops_equal_unsharded(case, unsharded):
    label, case = case
    assert case["drops"] == unsharded[label]["drops"]
    if CASES[label][1] in ("biased", "biased 3"):
        assert case["drops"] > 0  # the biased router drops


def test_three_clipped_steps_match_unsharded(case, unsharded):
    label, case = case
    u = unsharded[label]
    assert u["norm"] > 10 * OCFG.grad_clip  # clipping acts
    ranks = case["train_losses"]
    assert all(r == ranks[0] for r in ranks)
    np.testing.assert_allclose(ranks[0], u["train_losses"], rtol=LOSS_TOL)
    assert not any(case["train_skipped"])
    for i, (g, w) in enumerate(zip(case["train_params"], u["train_params"])):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"{label} leaf {i}")


def test_no_collective_without_autograd(case):
    label, case = case
    assert not [w for w in case["warnings"] if "autograd kernel" in w], case["warnings"]


def test_poisoned_shard_skips_on_every_rank(check_label, world):
    case = world[check_label]
    assert all(case["poison_skipped"]) and all(case["poison_unchanged"])


def test_run_resilient_restores_shards_bit_for_bit(check_label, world):
    case = world[check_label]
    got, want = case["resilient_losses"]
    assert got[:3] == want[:3] and got[3:] == want[2:]  # restored at step 2, step 3 again
    assert all(case["resilient_equal"])
    assert case["restored"] == (True, 4) and all(case["restored_shapes"])


def test_reference_checkpoint_manager_restores_the_sharded_checkpoint(check_label, world):
    import jax

    from repro.train.checkpoint import CheckpointManager as RCheckpointManager

    case, cfg = world[check_label], config(check_label)
    rtree = reference_tree(check_label)[1]
    template = {"params": rtree, "opt": {"m": rtree, "v": rtree,
                                         "step": np.zeros((), np.int32)}}
    step, restored, _ = RCheckpointManager(case["ckpt_dir"]).restore(template)
    params, moments, opt_step = case["ckpt_state"]
    assert step == 2 and int(np.asarray(restored["opt"]["step"])) == opt_step == 2
    for got, want in ((restored["params"], params), (restored["opt"]["m"], moments["m"]),
                      (restored["opt"]["v"], moments["v"])):
        got = jax.tree_util.tree_leaves(got)
        want = reference_layout(cfg, want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)
