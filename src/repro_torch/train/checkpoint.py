"""Atomic checkpoints with deterministic resume (port of
``repro/train/checkpoint.py``).

Layout, as the reference's: ``<dir>/step_<k>/proc_<i>.npz`` + ``meta.json``;
a checkpoint only counts once its directory is published, which happens last
and atomically (``meta.json`` is written into a temporary directory after the
arrays, then the directory is renamed), so a failure mid-save can never leave
a half checkpoint that restore would pick up.  Keep-last-k garbage
collection included.

The keys are the reference's (``_flatten``: each dict key as ``['name']``,
each list index as ``[i]``, joined by ``/``), and so are the arrays: the port
keeps a model's layers as a list of per-layer dicts, which is stacked on
save into the reference's ``(n_layers, ...)`` arrays and split again on
restore.  The ``hybrid`` and ``ssm`` families' layers differ within a period;
the reference keeps them as ``periods``, one tree per position of the period
stacked over the periods.  ``to_periods`` lays a tree's ``layers`` out so
(a list of per-position lists of the same tensors, saved as
``['periods']/[pos]/...``) and ``from_periods`` takes it back; ``Trainer``
saves and restores those families through them.  bf16 is stored as its
16-bit pattern (``uint16``) under the key with ``::bfloat16`` appended, as
the reference stores it.  So either package restores the other's
checkpoint.  A list of blocks that differ given as it is raises.

One process saves everything as ``proc_0``; the port runs on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

Tree = Any
BF16_TAG = "::bfloat16"


def _key(parts: tuple) -> str:
    """The reference's key of a path: a dict key as ``['name']``, a list
    index as ``[i]``."""
    return "/".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in parts)


def _stackable(items) -> bool:
    """A list of per-layer dicts of one structure."""
    return (len(items) > 0 and all(isinstance(t, dict) for t in items)
            and all(_paths(t) == _paths(items[0]) for t in items))


def _indexed(items) -> bool:
    """A list of lists (``periods``): each item is keyed by its index."""
    return len(items) > 0 and all(isinstance(t, (list, tuple)) for t in items)


def _paths(tree: Tree, prefix: tuple = ()) -> list[tuple]:
    """The key paths of a tree's leaves in sorted key order; a stackable
    list contributes its items' paths once, an indexed list each item's
    under its index."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        if _indexed(tree):
            return [p for i, t in enumerate(tree) for p in _paths(t, prefix + (i,))]
        if not _stackable(tree):
            raise NotImplementedError(
                f"checkpoint: {_key(prefix)} is a list of blocks that differ; lay it out as "
                "periods (to_periods) or give per-layer dicts of one structure")
        return _paths(tree[0], prefix)
    return [prefix]


def _get(tree: Tree, path: tuple):
    """The leaf at ``path``; through a stackable list, the list of its items'
    leaves."""
    for i, k in enumerate(path):
        if isinstance(tree, (list, tuple)) and not isinstance(k, int):
            return [_get(t, path[i:]) for t in tree]
        tree = tree[k]
    return tree


def to_periods(tree: Tree, period: int) -> Tree:
    """``tree`` with every ``layers`` list laid out as the reference's
    ``periods``: position ``pos`` holds layers ``pos, pos + period, ...``
    (the same tensors, not copies)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, list):
            if len(v) % period:
                raise ValueError(f"checkpoint: {len(v)} layers are not whole periods of {period}")
            out["periods"] = [list(v[pos::period]) for pos in range(period)]
        else:
            out[k] = to_periods(v, period)
    return out


def from_periods(tree: Tree) -> Tree:
    """``to_periods`` undone: every ``periods`` back to a ``layers`` list."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "periods":
            period, n = len(v), sum(len(t) for t in v)
            out["layers"] = [v[l % period][l // period] for l in range(n)]
        else:
            out[k] = from_periods(v)
    return out


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """(array, key suffix): bf16 as its uint16 pattern under ``::bfloat16``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16_TAG
        return t.numpy(), ""
    return np.asarray(t), ""


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    flat = {}
    for path in _paths(tree):
        leaf = _get(tree, path)
        if isinstance(leaf, list):  # per-layer list: the reference's stacked array
            arrs = [_to_numpy(t) for t in leaf]
            arr, tag = np.stack([a for a, _ in arrs]), arrs[0][1]
        else:
            arr, tag = _to_numpy(leaf)
        flat[_key(path) + tag] = arr
    return flat


def _unflatten(template: Tree, flat: dict[str, np.ndarray]) -> Tree:
    decoded: dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        if key.endswith(BF16_TAG):
            key = key[: -len(BF16_TAG)]
            decoded[key] = torch.from_numpy(np.asarray(val).view(np.int16)).view(
                torch.bfloat16)
        elif "::" in key:
            raise ValueError(f"checkpoint: {key} has a type this package does not read")
        else:
            decoded[key] = torch.from_numpy(np.asarray(val))  # np.load's own array, 0-d kept

    def build(t, path, i=None, n=None):
        """``t``'s structure; a stackable list's items take row ``i`` of
        ``n`` of each stacked array."""
        if isinstance(t, dict):
            return {k: build(v, path + (str(k),), i, n) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if _indexed(t):
                return type(t)(build(x, path + (j,), i, n) for j, x in enumerate(t))
            _paths(t, path)  # raises unless stackable
            return type(t)(build(x, path, j, len(t)) for j, x in enumerate(t))
        return leaf(t, path, i, n)

    def leaf(like, path, i, n):
        key = _key(path)
        if key not in decoded:
            raise KeyError(f"checkpoint missing {key}")
        val = decoded[key]
        want = (n, *like.shape) if n is not None else tuple(like.shape)
        if tuple(val.shape) != want:
            raise ValueError(f"{key}: shape {tuple(val.shape)} != template {want}")
        val = val[i] if n is not None else val
        return val.to(device=like.device, dtype=like.dtype)

    return build(template, ())


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, tree: Tree, extra: dict | None = None) -> Path:
        proc = 0
        tmp = self.dir / f".tmp_step_{step:08d}_{proc}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _flatten(tree)
        np.savez(tmp / f"proc_{proc}.npz", **flat)
        meta = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(flat),
            "extra": extra or {},
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return final

    def steps(self) -> list[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Tree, step: int | None = None) -> tuple[int, Tree, dict]:
        """(step, a tree like ``template`` with the checkpoint's values on the
        template's devices and in its dtypes, the saved ``extra``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        meta = json.loads((d / "meta.json").read_text())
        flat: dict[str, np.ndarray] = {}
        for f in sorted(d.glob("proc_*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    flat[k] = z[k]
        return step, _unflatten(template, flat), meta.get("extra", {})

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
