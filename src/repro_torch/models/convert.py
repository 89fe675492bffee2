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
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .model import Params, check_family


def params_from_numpy(cfg: ModelConfig, tree: dict[str, Any], device="cuda") -> Params:
    check_family(cfg)
    conv = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731

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
