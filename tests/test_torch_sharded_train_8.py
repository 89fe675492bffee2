"""Elastic re-meshing in CPU ``gloo`` worlds: a reduced MiniCPM-2B trained two
steps on a (data 2, model 2) mesh of a 4-rank world leaves a checkpoint,
which an 8-rank world restores onto (data 2, model 4) and (pod 2, data 2,
model 2) and the unsharded trainer restores with no mesh; each takes one more
step (one microbatch, which the 4 data-parallel ranks of (2, 2, 2)
split).  The restored parameters and moments are the checkpoint's bit for bit
on every mesh, and the step after the restore is the unsharded one's within
1e-5 (the same inputs, sums in other orders).  The helpers are
``torch_sharded_train_cases.py``'s."""
import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh, run_world
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import Trainer
from torch_sharded_train_cases import OCFG, PORT_TOL, TIMEOUT_S, _full, _np, dcfg_of, tcfg_of

ARCH_LABEL = "minicpm 1x2"
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _cfg():
    from torch_sharded_train_cases import config

    return config(ARCH_LABEL)


def _state(tr) -> list | None:
    """Parameters and moments, gathered to rank 0, in ``tree_leaves`` order
    (None on the other ranks)."""
    parts = [_full(part, tr._ctx.specs, tr.mesh)
             for part in (tr.params, tr.opt_state["m"], tr.opt_state["v"])]
    return None if parts[0] is None else [a for part in parts for a in part]


def save_on_2x2(ckpt: str) -> list:
    cfg = _cfg()
    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(ckpt, ckpt_every=2, accum_steps=1),
                 mesh=make_mesh((2, 2), ("data", "model"), device="cpu"), device="cpu")
    tr.run(2)
    return _state(tr)


def restore_and_step(ckpt: str) -> dict:
    cfg = _cfg()
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(ckpt, ckpt_every=100, accum_steps=1), mesh=mesh,
                     device="cpu")
        fresh = [tuple(t.shape) for t in tree_leaves(tr.params)]
        restored = tr.try_restore()
        shards = [tuple(t.shape) for t in tree_leaves(tr.params)] == fresh
        state = _state(tr)
        tr.run(1)
        after = _state(tr)
        out[name] = dict(restored=(restored, tr.step), shards=shards, state=state,
                         loss=tr.history[-1]["loss"],
                         after=None if after is None else after[:len(fresh)])
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def remeshed(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("remesh"))
    saved = run_world(4, save_on_2x2, (ckpt,), timeout_s=TIMEOUT_S, threads=1)
    return ckpt, saved, run_world(8, restore_and_step, (ckpt,), timeout_s=TIMEOUT_S,
                                  threads=1)


@pytest.fixture(scope="module")
def unsharded(remeshed):
    cfg = _cfg()
    tr = Trainer(cfg, OCFG, dcfg_of(cfg), tcfg_of(remeshed[0], ckpt_every=100, accum_steps=1), device="cpu")
    assert tr.try_restore() and tr.step == 2
    state = [a for part in (tr.params, tr.opt_state["m"], tr.opt_state["v"]) for a in _np(part)]
    n = len(tree_leaves(tr.params))
    tr.run(1)
    return state, tr.history[-1]["loss"], _np(tr.params), n


def test_no_mesh_restores_the_saved_state(remeshed, unsharded):
    for got, want in zip(unsharded[0], remeshed[1]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_restored_onto_another_mesh_bit_for_bit(remeshed, mesh):
    case = remeshed[2][mesh]
    assert case["restored"] == (True, 3) and case["shards"]
    assert len(case["state"]) == len(remeshed[1])
    for got, want in zip(case["state"], remeshed[1]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_after_the_restore_matches_unsharded(remeshed, unsharded, mesh):
    case = remeshed[2][mesh]
    _, loss, params, _ = unsharded
    assert case["loss"] == pytest.approx(loss, rel=PORT_TOL)
    for i, (got, want) in enumerate(zip(case["after"], params)):
        np.testing.assert_allclose(got, want, atol=PORT_TOL, rtol=0, err_msg=str(i))
