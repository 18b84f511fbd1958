"""Carry actor and critic weights between flax params and the torch modules.

A flax `Dense_i` stores `kernel [in, out]` and `bias [out]`; `nn.Linear`
stores `weight [out, in]`. The flax tree of either network is
`{"params": {"MLP_0": {"Dense_i": {"kernel", "bias"}}}}`, and the actor's also
holds `params/std`. `*_from_flax` maps `Dense_i` onto the i-th Linear layer
(and `std` onto `std`); `flax_params` writes that tree back as numpy arrays,
the layout the checkpoint pickles hold.
"""
from __future__ import annotations

import numpy as np
import torch


def state_dict_from_flax(flax_params, net) -> dict:
    """`net`'s state_dict from flax params of the same architecture (an actor
    or a critic of `agents/networks.py`)."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    dense = p["MLP_0"]
    linears = net.linear_layers()
    if len(dense) != len(linears):
        raise ValueError(f"checkpoint has {len(dense)} Dense layers, the network has {len(linears)}")
    inv = {id(m): n for n, m in net.named_modules()}
    sd = {}
    for i, lin in enumerate(linears):
        d = dense[f"Dense_{i}"]
        kernel = np.asarray(d["kernel"], dtype=np.float32)
        if kernel.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"Dense_{i} kernel {kernel.shape} != ({lin.in_features}, {lin.out_features})")
        sd[f"{inv[id(lin)]}.weight"] = torch.from_numpy(kernel.T.copy())
        sd[f"{inv[id(lin)]}.bias"] = torch.from_numpy(np.asarray(d["bias"], dtype=np.float32).copy())
    if hasattr(net, "std"):
        sd["std"] = torch.from_numpy(np.asarray(p["std"], dtype=np.float32).copy())
    return sd


def from_flax(flax_params, net):
    """Load flax params (a numpy dict) into `net` in place; returns it."""
    net.load_state_dict(state_dict_from_flax(flax_params, net))
    return net


def flax_params(net) -> dict:
    """`net`'s weights as the flax params tree, float32 numpy arrays."""
    dense = {}
    for i, lin in enumerate(net.linear_layers()):
        dense[f"Dense_{i}"] = {"bias": lin.bias.detach().cpu().numpy().copy(),
                               "kernel": lin.weight.detach().cpu().numpy().T.copy()}
    params = {"MLP_0": dense}
    if hasattr(net, "std"):
        params["std"] = net.std.detach().cpu().numpy().copy()
    return {"params": params}
