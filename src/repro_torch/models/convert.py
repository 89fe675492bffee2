"""Carry the reference's parameters into the port.

``params_from_numpy`` takes the pytree of ``repro.models.model.init_params``
as numpy arrays (layers stacked on a leading ``(n_layers, ...)`` axis) and
returns the port's parameters (a list of per-layer dicts), so both packages
compute the same function in the tests.  Weight layouts are the same
``(d_in, d_out)``; nothing is transposed.
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
    p: Params = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head") if k in tree}
    stacked = tree["layers"]
    p["layers"] = [
        {
            "norm1": conv(stacked["norm1"][l]),
            "mixer": {k: conv(w[l]) for k, w in stacked["mixer"].items()},
            "norm2": conv(stacked["norm2"][l]),
            "ffn": {k: conv(w[l]) for k, w in stacked["ffn"].items()},
        }
        for l in range(cfg.n_layers)
    ]
    return p
