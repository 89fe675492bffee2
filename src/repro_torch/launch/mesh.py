"""Meshes over a ``torch.distributed`` world.

Port of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a function
(importing this module touches no device and starts no process).  Single
pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis composes with ``data`` for the
gradient all-reduce.  A production mesh is built only over a world of
exactly that size: it never shrinks to fit.

A :class:`Mesh` names its axes and holds the size of each, this rank's
process group along each (and along the data-parallel axes together, the
gradient all-reduce's group, where there are two), the global ranks laid
out row-major over the shape, and the device this rank computes on.  The
partition planner reads only the axis sizes (``mesh.shape``).  It is the port's own class and not
``torch.distributed.device_mesh.DeviceMesh`` because a mesh of one needs no
process group (``DeviceMesh`` starts one), and because its device and its
collective backend are chosen apart: two ranks on one card compute on the
card while their collectives run on ``gloo`` (NCCL refuses two ranks on one
device).  The backend is the caller's: ``nccl`` where every rank has a card
of its own, ``gloo`` otherwise.

``set_mesh(mesh)`` makes a mesh the one the model code reads
(``current_mesh()``) inside a ``with`` block, as ``jax.set_mesh`` does for
the reference's sharding hints.

``run_world(n, fn, args)`` runs ``fn(*args)`` on every rank of a fresh
``n``-rank world of spawned processes and returns rank 0's result; a
rank's exception fails the whole call with its traceback.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import os
import shutil
import tempfile
from datetime import timedelta
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of the current world (or of no world, for
    a mesh of one)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device: torch.device,
                 groups: dict[str, Any], ranks: tuple[int, ...], rank: int):
        self.shape = dict(zip(axes, shape))  # axis -> size, in axis order
        self.axis_names = tuple(axes)
        self.device = device
        self.ranks = ranks  # global ranks, row-major over the shape
        self.rank = rank
        self._groups = groups

    def size(self, axis: str) -> int:
        """The number of ranks along ``axis``."""
        return self.shape[axis]

    def get_group(self, axis):
        """This rank's process group along ``axis`` (None in a mesh of one),
        or along several axes together (a tuple of names, the data-parallel
        axes ``dp_axes`` included)."""
        if isinstance(axis, tuple):
            return self._groups[axis[0] if len(axis) == 1 else axis]
        return self._groups[axis]

    def local_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        g = self._groups[axis]
        return 0 if g is None else dist.get_rank(g)


def _rank_device(device, rank: int) -> torch.device:
    """The device this rank computes on: the card unless the caller asks
    for the CPU; ``cuda`` without an index takes card ``rank % count``."""
    from ..core.codegen import check_device

    dev = check_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _world_timeout():
    """The default group's collective timeout, which the mesh's groups take
    (None, the backend's default, where it cannot be read)."""
    try:
        return dist.group.WORLD._get_backend(torch.device("cpu")).options._timeout
    except Exception:  # noqa: BLE001 — a backend without CPU options (nccl)
        return None


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> Mesh:
    """A mesh of ``shape`` over the whole current world, named by ``axes``.

    Without an initialised process group only a mesh of one is possible.
    Every rank must call this in the same order: it creates one process
    group per line of ranks along each axis (the world's own group where a
    line is the whole world)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    n = math.prod(shape)
    live = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if live else (1, 0)
    if n != world:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the world has {world}")
    grid = np.arange(n).reshape(shape)
    groups: dict[Any, Any] = {}
    dp = tuple(a for a in ("pod", "data") if a in axes)
    # one group per line of ranks along each axis, and along the DP axes
    # together (the gradient all-reduce's group) where there are two
    for along in [(ax,) for ax in axes] + ([dp] if len(dp) > 1 else []):
        key = along[0] if len(along) == 1 else along
        groups[key] = None
        if not live:
            continue
        inner = [axes.index(a) for a in along]
        outer = [d for d in range(len(axes)) if d not in inner]
        lines = np.transpose(grid, outer + inner).reshape(-1, math.prod(shape[d] for d in inner))
        for line in lines:
            members = [int(r) for r in line]
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members, timeout=_world_timeout()))
            if rank in members:
                groups[key] = g
    return Mesh(shape, axes, _rank_device(device, rank), groups,
                tuple(int(r) for r in grid.reshape(-1)), rank)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axes (pod folds into DP for the batch dimension)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """``with set_mesh(mesh):`` makes ``mesh`` (or None: no mesh) the one
    ``current_mesh()`` returns, and restores the previous one after."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh():
    """The mesh of the innermost ``set_mesh`` block, else None."""
    return _CURRENT.get()


# ---------------------------------------------------------------------------
# an n-rank world of spawned processes
# ---------------------------------------------------------------------------
def _rank_main(rank: int, n: int, tmp: str, backend: str, timeout_s: float,
               threads: int | None, fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=n,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.part"))
            os.replace(os.path.join(tmp, "result.part"), os.path.join(tmp, "result.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(n: int, fn: Callable, args: tuple = (), *, backend: str = "gloo",
              timeout_s: float = 600.0, threads: int | None = None) -> Any:
    """Run ``fn(*args)`` on every rank of a fresh ``n``-rank world and
    return rank 0's result.

    Ranks are spawned (``torch.multiprocessing``, start method ``spawn``:
    a parent that has initialised CUDA cannot fork) and meet through a file
    store in a fresh temporary directory, so two worlds never meet.  ``fn``
    and ``args`` are pickled to every rank and ``fn`` must be importable.  A
    rank that raises or dies fails the whole call with its traceback
    (``torch.multiprocessing.ProcessRaisedException`` /
    ``ProcessExitedException``) and the other ranks are terminated: the
    call never yields a smaller world.  ``timeout_s`` bounds each
    collective; ``threads`` sets each rank's intra-op threads."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"a world needs at least one rank, not {n}")
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    try:
        mp.start_processes(_rank_main, args=(n, tmp, backend, timeout_s, threads, fn, args),
                           nprocs=n, join=True, start_method="spawn")
        # written by this call's rank 0 above
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
