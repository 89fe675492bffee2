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
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager

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
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(NotImplementedError):
        mgr.save(1, {"layers": [{"a": torch.zeros(1)}, {"b": torch.zeros(1)}]})


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
