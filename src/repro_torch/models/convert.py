"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the pytree of ``repro.models.model.init_params``
as numpy arrays and returns the port's parameters (lists of per-layer dicts:
``layers``, or ``encoder`` and ``decoder`` for audio), so both packages
compute the same function in the tests.  The reference stacks layers on a
leading ``(n_layers, ...)`` axis, or for ``hybrid`` and ``ssm`` keeps
``periods``: one tree per position in the period, each stacked over the
periods, so its block ``periods[pos]`` at index ``g`` is layer
``g * period + pos``.  Weight layouts are the same ``(d_in, d_out)``;
nothing is transposed.

``opt_state_from_numpy`` carries the reference's AdamW state (``m`` and
``v`` shaped like the parameters, and ``step``) the same way, so a training
step can be held against the reference's from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import Params, check_family


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 (ml_dtypes) through its 16-bit
    pattern, which torch cannot take directly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ModelConfig, tree: dict[str, Any], device="cuda") -> Params:
    check_family(cfg)
    conv = lambda a: _tensor(a).to(device)  # noqa: E731

    def unstack(stacked: dict, n: int) -> list[Params]:
        return [{k: ({name: conv(w[l]) for name, w in v.items()} if isinstance(v, dict)
                     else conv(v[l])) for k, v in stacked.items()} for l in range(n)]

    p: Params = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head", "enc_final_norm")
                 if k in tree}
    if cfg.family == "audio":
        p["encoder"] = unstack(tree["encoder"], cfg.enc_layers)
        p["decoder"] = unstack(tree["decoder"], cfg.n_layers)
    elif "periods" in tree:
        period = len(tree["periods"])
        per_pos = [unstack(t, cfg.n_layers // period) for t in tree["periods"]]
        p["layers"] = [per_pos[l % period][l // period] for l in range(cfg.n_layers)]
    else:
        p["layers"] = unstack(tree["layers"], cfg.n_layers)
    return p


def opt_state_from_numpy(cfg: ModelConfig, state: dict[str, Any], device="cuda") -> dict:
    """The reference's ``adamw_init``/``adamw_update`` state as numpy arrays
    -> the port's (``optim.adamw``): fp32 moments in the port's layout on
    ``device``, the step as a 0-d int32 tensor on the host."""
    return {"m": params_from_numpy(cfg, state["m"], device),
            "v": params_from_numpy(cfg, state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}
