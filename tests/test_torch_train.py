"""The port's training (``repro_torch.data``, ``repro_torch.train``) against
the reference's (``repro.data``, ``repro.train``) at reduced MiniCPM-2B
(fp32, remat none) on the CPU.

Parameters come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; batches come from the data pipelines, which must
agree array for array.  Tolerances: the loss within 1e-5 relative and each
gradient within 1e-4 relative to its tensor's largest value (fp32; both
sides sum in other orders), parameters after three AdamW steps within 1e-5
(AdamW divides by the root of the second moment, so a small difference in a
gradient moves a parameter by at most lr times a small fraction) and moments
within 1e-4 relative to each tensor's largest value.  Block remat recomputes
the same operations and must give bit-identical gradients.  The reference's
Trainer tests (resume bit-exact, injected failure recovers, straggler
monitor, heartbeat) are mirrored.
"""
import time
import warnings
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import LMDataPipeline as RPipeline
from repro.models import model as RM
from repro.optim.adamw import AdamWConfig as RAdamW
from repro.optim.adamw import adamw_init as r_adamw_init
from repro.train import train_loop as RT
from repro_torch.configs import get_config as p_config
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.fault import Heartbeat, StragglerMonitor
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train import train_loop as PT

torch.set_num_threads(1)
ARCH = "minicpm-2b"
RCFG, PCFG = r_config(ARCH).reduced(), p_config(ARCH).reduced()
GRAD_TOL = 1e-4


def _dcfg(cls=DataConfig, **kw):
    base = dict(seq_len=16, global_batch=4, vocab=PCFG.vocab, seed=11)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def params():
    rparams = RM.init_params(RCFG, jax.random.PRNGKey(0))
    return rparams, jax.tree_util.tree_map(np.asarray, rparams)


def _port_params(np_params):
    p = params_from_numpy(PCFG, np_params, "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    return p


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_close_scaled(got, want, tol, what=""):
    """Within ``tol`` times the reference tensor's largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def _reference_order(tree):
    """The port's tree (per-layer lists) as the reference's leaves: stacked."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, list):
            out[k] = {kk: (torch.stack([blk[kk] for blk in v]) if not isinstance(v[0][kk], dict)
                           else {n: torch.stack([blk[kk][n] for blk in v]) for n in v[0][kk]})
                      for kk in v[0]}
        else:
            out[k] = v
    return out


def _pairs(port_tree, ref_tree):
    """(port leaf, reference leaf) in the reference's order."""
    ported = tree_leaves(_reference_order(port_tree))
    return zip(ported, jax.tree_util.tree_leaves(ref_tree))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5, 123])
def test_synthetic_batches_equal_the_reference(step):
    got = LMDataPipeline(_dcfg()).batch_at(step)
    want = RPipeline(_dcfg(RDataConfig)).batch_at(step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_memmap_batches_equal_the_reference_on_two_shards(tmp_path):
    f = tmp_path / "tokens.bin"
    (np.arange(10_000, dtype=np.uint32) * 7919 % 1000).tofile(f)
    for shard in (0, 1):
        kw = dict(source="memmap", path=str(f), shard_index=shard, shard_count=2)
        got = LMDataPipeline(_dcfg(**kw)).batch_at(3)
        want = RPipeline(_dcfg(RDataConfig, **kw)).batch_at(3)
        assert got["tokens"].shape == (2, 16) and got["tokens"].max() < PCFG.vocab
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_iterator_order():
    p = LMDataPipeline(_dcfg())
    p.start(7)
    steps = [p.next()[0] for _ in range(3)]
    p.stop()
    assert steps == [7, 8, 9]


# ---------------------------------------------------------------------------
# loss, gradients, steps
# ---------------------------------------------------------------------------
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(RT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(PT.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    # bf16 logits are widened to fp32 first
    got16 = PT.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got16.dtype == torch.float32


def test_loss_and_every_gradient_match_reference(params):
    rparams, np_params = params
    batch = LMDataPipeline(_dcfg()).batch_at(2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(RCFG, p, _jbatch(batch)))(rparams)
    pparams = _port_params(np_params)
    loss = PT.loss_fn(PCFG, pparams, _tbatch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(pparams))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    pairs = list(_pairs(tree_unflatten(pparams, list(grads)), want_grads))
    assert len(pairs) == len(jax.tree_util.tree_leaves(want_grads))
    for got, want in pairs:
        _assert_close_scaled(got.detach().numpy(), np.asarray(want), GRAD_TOL)


def test_block_remat_gives_the_same_gradients(params):
    _, np_params = params
    batch = _tbatch(LMDataPipeline(_dcfg()).batch_at(4))
    out = []
    for remat in ("none", "block"):
        p = _port_params(np_params)
        loss = PT.loss_fn(replace(PCFG, remat=remat), p, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(p))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_unported_remat_modes_raise(params):
    """``"layer"`` (the reference's per-position remat of a hybrid or ssm
    period) is not ported; ``"block_save_moe"`` is, and its MoE gradients are
    held in tests/test_torch_train_families.py."""
    _, np_params = params
    batch = _tbatch(LMDataPipeline(_dcfg()).batch_at(0))
    with pytest.raises(NotImplementedError):
        PT.loss_fn(replace(PCFG, remat="layer"), _port_params(np_params), batch)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(params, accum):
    rparams, np_params = params
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, schedule="wsd")
    r_step = jax.jit(RT.make_train_step(RCFG, RAdamW(**ocfg), accum_steps=accum))
    p_step = make_train_step(PCFG, AdamWConfig(**ocfg), accum_steps=accum)
    r_state = r_adamw_init(rparams)
    pparams = _port_params(np_params)
    p_state = opt_state_from_numpy(PCFG, jax.tree_util.tree_map(np.asarray, r_state), "cpu")
    data = LMDataPipeline(_dcfg())
    for step in range(3):
        batch = data.batch_at(step)
        rparams, r_state, r_m = r_step(rparams, r_state, _jbatch(batch))
        pparams, p_state, p_m = p_step(pparams, p_state, _tbatch(batch))
        assert float(p_m["loss"]) == pytest.approx(float(r_m["loss"]), rel=1e-5)
        assert float(p_m["grad_norm"]) == pytest.approx(float(r_m["grad_norm"]), rel=1e-4)
        assert int(p_state["step"]) == step + 1
        for got, want in _pairs(pparams, rparams):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for name in ("m", "v"):
            for got, want in _pairs(p_state[name], r_state[name]):
                _assert_close_scaled(got.numpy(), np.asarray(want), GRAD_TOL, name)


def test_pod_axis_and_mesh_are_refused(tmp_path, params):
    """Still refused: a ``grad_codec`` over a ``pod_axis`` (step 3b),
    ``seq_parallel`` (3b) and the recurrent and audio families under a mesh
    of more than one rank (3a-iii).  A mesh of one trains bit for bit as no
    mesh does."""
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="3b"):
        make_train_step(PCFG, AdamWConfig(), grad_codec="int8", pod_axis="pod")
    with pytest.raises(NotImplementedError, match="3b"):
        PT.loss_fn(replace(PCFG, seq_parallel=True), _port_params(params[1]),
                   _tbatch(LMDataPipeline(_dcfg()).batch_at(0)))

    class TwoRanks:
        shape, axis_names = {"data": 1, "model": 2}, ("data", "model")

    for arch in ("jamba-1.5-large-398b", "xlstm-350m", "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="3a-iii"):
            Trainer(p_config(arch).reduced(), AdamWConfig(), _dcfg(),
                    TrainerConfig(ckpt_dir=str(tmp_path)), mesh=TwoRanks(), device="cpu")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=0.05)
    runs = []
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        tr = Trainer(PCFG, ocfg, _dcfg(), TrainerConfig(ckpt_dir=str(tmp_path / str(mesh)),
                                                        accum_steps=2, ckpt_every=100),
                     mesh=mesh, device="cpu")
        tr.run(2)
        runs.append(tr)
    assert [h["loss"] for h in runs[0].history] == [h["loss"] for h in runs[1].history]
    for a, b in zip(tree_leaves(runs[0].params) + tree_leaves(runs[0].opt_state),
                    tree_leaves(runs[1].params) + tree_leaves(runs[1].opt_state)):
        assert torch.equal(a, b)


def test_trainer_refuses_a_device_other_than_the_meshs(tmp_path):
    """Under a mesh the mesh decides the device: naming another raises."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        Trainer(PCFG, AdamWConfig(), _dcfg(), TrainerConfig(ckpt_dir=str(tmp_path)), mesh=mesh,
                device="cuda")
    tr = Trainer(PCFG, AdamWConfig(), _dcfg(), TrainerConfig(ckpt_dir=str(tmp_path)), mesh=mesh)
    assert tr.device == mesh.device


def test_trainer_asks_for_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(PCFG, AdamWConfig(), _dcfg(), TrainerConfig(ckpt_dir=str(tmp_path)))


# ---------------------------------------------------------------------------
# the reference's Trainer tests, mirrored
# ---------------------------------------------------------------------------
def _trainer(tmp_path, **kw):
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    return Trainer(PCFG, ocfg, _dcfg(), TrainerConfig(ckpt_dir=str(tmp_path), **kw),
                   device="cpu")


def test_resume_is_bit_exact(tmp_path):
    t1 = _trainer(tmp_path, ckpt_every=4, log_every=100)
    t1.run(8)  # checkpoints at 4 and 8
    t2 = _trainer(tmp_path, ckpt_every=4, log_every=100)
    assert t2.try_restore() and t2.step == 8
    t1.run(2)
    t2.run(2)
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in t1.history[-2:]] == [h["loss"] for h in t2.history[-2:]]


def test_injected_failure_recovers_bit_exactly(tmp_path):
    t = _trainer(tmp_path / "a", ckpt_every=3)
    hist = t.run_resilient(8, fail_at=5)
    assert t.step == 8
    ref = _trainer(tmp_path / "b", ckpt_every=3)
    ref.run(8)
    assert [h["loss"] for h in hist[-3:]] == [h["loss"] for h in ref.history[-3:]]
    for a, b in zip(tree_leaves(t.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)


def test_failure_before_any_checkpoint_restarts_from_scratch(tmp_path):
    t = _trainer(tmp_path, ckpt_every=100)
    t.run_resilient(3, fail_at=1)
    ref = _trainer(tmp_path / "b", ckpt_every=100)
    ref.run(3)
    for a, b in zip(tree_leaves(t.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)


def test_trainer_reports_and_explains(tmp_path):
    t = _trainer(tmp_path, ckpt_every=100, heartbeat=str(tmp_path / "hb.json"))
    hist = t.run(2)
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["lr"] > 0 and not h["skipped"] for h in hist)
    assert Heartbeat.age(tmp_path / "hb.json") is not None
    report = t.explain_kernels()
    assert "contraction plans:" in report and "pass pipeline" in report


def test_straggler_monitor():
    m = StragglerMonitor(threshold=2.0)
    for s in range(10):
        m.observe(s, 1.0)
    assert m.observe(10, 5.0)
    assert m.flagged and m.flagged[0][0] == 10


def test_heartbeat(tmp_path):
    hb = Heartbeat(tmp_path / "hb.json", interval=0.05)
    hb.start()
    time.sleep(0.2)
    hb.stop()
    age = Heartbeat.age(tmp_path / "hb.json")
    assert age is not None and age < 5.0


def test_train_fault_shim_warns_on_import():
    import importlib
    import sys

    sys.modules.pop("repro_torch.train.fault", None)
    with pytest.warns(DeprecationWarning, match="repro_torch.fault"):
        importlib.import_module("repro_torch.train.fault")


def test_launch_cli_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--seq-len", "16", "--batch",
                    "4", "--accum", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "3"])
    assert "final step 3" in capsys.readouterr().out
    assert (tmp_path / "step_00000003" / "meta.json").exists()
