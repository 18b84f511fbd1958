"""Carry flax actor weights into the torch `GaussianActor`.

A flax `Dense_i` stores `kernel [in, out]` and `bias [out]`; `nn.Linear`
stores `weight [out, in]`. `actor_from_flax` maps `params/MLP_0/Dense_i` onto
the i-th Linear layer and `params/std` onto `std`.
"""
from __future__ import annotations

import numpy as np
import torch

from pbhc_tpu_torch.agents.networks import GaussianActor


def actor_state_dict_from_flax(actor_params, actor: GaussianActor) -> dict:
    p = actor_params["params"] if "params" in actor_params else actor_params
    dense = p["MLP_0"]
    linears = actor.linear_layers()
    if len(dense) != len(linears):
        raise ValueError(f"checkpoint has {len(dense)} Dense layers, actor has {len(linears)}")
    names = dict(actor.named_modules())
    inv = {id(m): n for n, m in names.items()}
    sd = {}
    for i, lin in enumerate(linears):
        d = dense[f"Dense_{i}"]
        kernel = np.asarray(d["kernel"], dtype=np.float32)
        if kernel.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"Dense_{i} kernel {kernel.shape} != ({lin.in_features}, {lin.out_features})")
        sd[f"{inv[id(lin)]}.weight"] = torch.from_numpy(kernel.T.copy())
        sd[f"{inv[id(lin)]}.bias"] = torch.from_numpy(np.asarray(d["bias"], dtype=np.float32).copy())
    sd["std"] = torch.from_numpy(np.asarray(p["std"], dtype=np.float32).copy())
    return sd


def actor_from_flax(actor_params, actor: GaussianActor) -> GaussianActor:
    """Load flax `actor_params` (a numpy dict) into `actor` in place; returns it."""
    actor.load_state_dict(actor_state_dict_from_flax(actor_params, actor))
    return actor
