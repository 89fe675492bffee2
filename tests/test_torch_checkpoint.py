"""The port's checkpoints (``repro_torch.train.checkpoint``) on the CPU:
round trip, keep-last-k, the atomic publish, and checkpoints restored across
packages both ways at reduced MiniCPM-2B (fp32 and bf16).  Values restore
bit-exactly."""
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro.optim.adamw import adamw_init as r_adamw_init
from repro.train.checkpoint import CheckpointManager as RManager
from repro.train.checkpoint import _flatten as r_flatten
from repro_torch.configs import get_config as p_config
from repro_torch.models import model as PM
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager, from_periods, to_periods

torch.set_num_threads(1)


def _tree():
    g = torch.Generator().manual_seed(0)
    layer = lambda: {"w": torch.randn(3, 2, generator=g),  # noqa: E731
                     "n": torch.randn(2, generator=g).bfloat16()}
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "layers": [layer(), layer(), layer()],
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _assert_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    mgr.save(10, tree, extra={"step": 10})
    step, got, extra = mgr.restore(_zeros_like(tree))
    assert step == 10 and extra == {"step": 10}
    _assert_equal(got, tree)
    with np.load(tmp_path / "step_00000010" / "proc_0.npz") as z:
        assert z["['layers']/['w']"].shape == (3, 3, 2)  # the per-layer list, stacked
        assert z["['layers']/['n']::bfloat16"].dtype == np.uint16


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(())})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4


def test_missing_key_and_wrong_shape_raise(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(2)})


def test_meta_json_is_written_last_and_published_atomically(tmp_path, monkeypatch):
    """meta.json goes into the temporary directory after the arrays, and the
    step directory appears only with both in it: a crash mid-save leaves
    nothing that ``steps()`` counts."""
    mgr = CheckpointManager(tmp_path)
    seen = []
    real = Path.write_text

    def spy(self, data, *a, **kw):
        if self.name == "meta.json":
            seen.append(((self.parent / "proc_0.npz").exists(), mgr.steps()))
        return real(self, data, *a, **kw)

    monkeypatch.setattr(Path, "write_text", spy)
    mgr.save(3, _tree())
    assert seen == [(True, [])]
    assert mgr.steps() == [3]
    assert not list(tmp_path.glob(".tmp_*"))


def test_blocks_that_differ_are_refused(tmp_path):
    """Blocks that differ within a period (the hybrid and ssm families')
    round-trip as the reference's ``periods`` (``to_periods``): one stacked
    tree per position, keyed ``['periods']/[pos]``; given as a plain list of
    blocks that differ they are still refused."""
    g = torch.Generator().manual_seed(1)
    blocks = [{"a": torch.randn(2, generator=g)} if l % 2 == 0
              else {"b": torch.randn(3, generator=g).bfloat16(), "c": torch.randn(1, generator=g)}
              for l in range(6)]
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(NotImplementedError):
        mgr.save(1, {"layers": blocks})
    tree = to_periods({"params": {"layers": blocks, "embed": torch.ones(2)}}, 2)
    assert [len(p) for p in tree["params"]["periods"]] == [3, 3]
    assert tree["params"]["periods"][1][2] is blocks[5]
    mgr.save(2, tree)
    with np.load(tmp_path / "step_00000002" / "proc_0.npz") as z:
        assert sorted(z.files) == ["['params']/['embed']", "['params']/['periods']/[0]/['a']",
                                   "['params']/['periods']/[1]/['b']::bfloat16",
                                   "['params']/['periods']/[1]/['c']"]
        assert z["['params']/['periods']/[1]/['b']::bfloat16"].shape == (3, 3)
    _, got, _ = mgr.restore(_zeros_like(tree))
    got = from_periods(got)
    _assert_equal(got["params"]["layers"], blocks)
    assert torch.equal(got["params"]["embed"], torch.ones(2))
    with pytest.raises(ValueError):
        to_periods({"layers": blocks[:5]}, 2)  # not whole periods


@pytest.fixture(params=["float32", "bfloat16"])
def model(request):
    arch = "minicpm-2b"
    rcfg = replace(r_config(arch).reduced(), dtype=request.param)
    pcfg = replace(p_config(arch).reduced(), dtype=request.param)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    ropt = r_adamw_init(rparams)
    ropt = {"m": jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5, jnp.float32), rparams),
            "v": jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 2.0, jnp.float32), rparams),
            "step": jnp.asarray(5, jnp.int32)} if request.param == "float32" else ropt
    rtree = {"params": rparams, "opt": ropt}
    np_tree = jax.tree_util.tree_map(np.asarray, rtree)
    ptree = {"params": params_from_numpy(pcfg, np_tree["params"], "cpu"),
             "opt": opt_state_from_numpy(pcfg, np_tree["opt"], "cpu")}
    return rtree, ptree


def test_reference_checkpoint_restores_in_the_port(tmp_path, model):
    rtree, ptree = model
    RManager(tmp_path).save(4, rtree)
    step, got, _ = CheckpointManager(tmp_path).restore(_zeros_like(ptree))
    assert step == 4
    _assert_equal(got, ptree)


def test_port_checkpoint_restores_in_the_reference(tmp_path, model):
    rtree, ptree = model
    CheckpointManager(tmp_path).save(6, ptree)
    template = jax.tree_util.tree_map(jnp.zeros_like, rtree)
    step, got, _ = RManager(tmp_path).restore(template)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(rtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "step_00000006" / "proc_0.npz") as z:
        assert sorted(z.files) == sorted(r_flatten(rtree))  # the reference's keys, tags included


# the hybrid and ssm families: reduced Jamba (one period of 8) and reduced
# xLSTM with an sLSTM in its pattern (two periods of ("m", "s"))
PERIOD_MODELS = {"hybrid": ("jamba-1.5-large-398b", {}),
                 "ssm": ("xlstm-350m", {"block_pattern": ("m", "s"), "n_layers": 4})}


@pytest.fixture(params=[(f, dt) for f in PERIOD_MODELS for dt in ("float32", "bfloat16")],
                ids=lambda p: "-".join(p))
def period_model(request):
    family, dtype = request.param
    arch, changes = PERIOD_MODELS[family]
    rcfg = replace(r_config(arch).reduced(), dtype=dtype, **changes)
    pcfg = replace(p_config(arch).reduced(), dtype=dtype, **changes)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(2))
    ropt = r_adamw_init(rparams)
    ropt = {"m": jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.25, jnp.float32), rparams),
            "v": jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 3.0, jnp.float32), rparams),
            "step": jnp.asarray(9, jnp.int32)} if dtype == "float32" else ropt
    rtree = {"params": rparams, "opt": ropt}
    np_tree = jax.tree_util.tree_map(np.asarray, rtree)
    ptree = {"params": params_from_numpy(pcfg, np_tree["params"], "cpu"),
             "opt": opt_state_from_numpy(pcfg, np_tree["opt"], "cpu")}
    return rtree, ptree, PM.layer_period(pcfg)


def test_reference_period_checkpoint_restores_in_the_port(tmp_path, period_model):
    rtree, ptree, period = period_model
    RManager(tmp_path).save(4, rtree)
    step, got, _ = CheckpointManager(tmp_path).restore(to_periods(_zeros_like(ptree), period))
    assert step == 4
    _assert_equal(from_periods(got), ptree)


def test_port_period_checkpoint_restores_in_the_reference(tmp_path, period_model):
    rtree, ptree, period = period_model
    CheckpointManager(tmp_path).save(6, to_periods(ptree, period))
    template = jax.tree_util.tree_map(jnp.zeros_like, rtree)
    step, got, _ = RManager(tmp_path).restore(template)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(rtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(tmp_path / "step_00000006" / "proc_0.npz") as z:
        assert sorted(z.files) == sorted(r_flatten(rtree))


def test_trainer_resumes_a_recurrent_model_bit_exactly(tmp_path):
    """``Trainer`` on reduced xLSTM (an sLSTM in the pattern) saves in the
    period layout and recovers from an injected failure bit-exactly."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    arch, changes = PERIOD_MODELS["ssm"]
    cfg = replace(p_config(arch).reduced(), **changes)

    def trainer(sub, every):
        return Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6),
                       DataConfig(seq_len=8, global_batch=2, vocab=cfg.vocab, seed=5),
                       TrainerConfig(ckpt_dir=str(tmp_path / sub), ckpt_every=every),
                       device="cpu")

    t = trainer("a", 2)
    hist = t.run_resilient(4, fail_at=3)
    with np.load(tmp_path / "a" / "step_00000002" / "proc_0.npz") as z:
        assert "['params']/['periods']/[1]/['mixer']/['wz']" in z.files
    ref = trainer("b", 100)
    ref.run(4)
    assert [h["loss"] for h in hist[-2:]] == [h["loss"] for h in ref.history[-2:]]
    for a, b in zip(tree_leaves(t.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
