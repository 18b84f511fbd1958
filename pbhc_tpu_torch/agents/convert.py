"""Carry network weights between flax params and the torch modules.

Each torch layer has a path in the flax tree:
- an `MLP`'s i-th Linear is `Dense_i` under the MLP's path; the `mlp` of
  `GaussianActor` and `Critic` is flax's `MLP_0`, so their trees are
  `{"params": {"MLP_0": {"Dense_i": ...}}}` (the actor's also holds `std`);
- a `MoEMLP`'s stacked expert layers are `experts/Dense_i` (flax's `nn.vmap`
  over an `MLP` stacks each leaf on axis 0) and its gate is `gate`;
- the `phase_embed` of the phase-aware networks is flax's `PhaseEmbed_0`
  (a `Dense_0` under it when learnable, nothing when sinusoidal);
- any other submodule sits under its own attribute name, which the mimic
  networks choose to be flax's (`params/actor/history_encoder/Conv_0`,
  `params/critic_ln`, ...); a module's own parameter (`std`) is a leaf.

Per layer: `Dense` `kernel [in, out]` is `nn.Linear.weight [out, in]`; `Conv`
`kernel [k, in, out]` is `nn.Conv1d.weight [out, in, k]`; a stacked expert
layer keeps flax's `kernel [E, in, out]` and `bias [E, out]`; `LayerNorm`
`scale` is its `weight`; biases are equal. `state_dict_from_flax` maps a flax tree
onto a network and refuses one whose layers or shapes differ;
`flax_params` writes the network back as that tree of float32 numpy arrays,
the layout the checkpoint pickles hold.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pbhc_tpu_torch.agents.networks import MLP, LayerNorm, MoEMLP, StackedLinear

_FLAX_NAME = {"mlp": "MLP_0", "phase_embed": "PhaseEmbed_0"}


def _layers(module, path=()):
    """(flax path, torch layer) for every parameterised layer of `module`,
    and (flax path, parameter) for every parameter a module holds itself."""
    if isinstance(module, MLP):
        for i, lin in enumerate(module.linear_layers()):
            yield path + (f"Dense_{i}",), lin
        return
    if isinstance(module, MoEMLP):
        for i, layer in enumerate(module.experts):
            yield path + ("experts", f"Dense_{i}"), layer
        yield path + ("gate",), module.gate
        return
    if isinstance(module, (nn.Linear, nn.Conv1d, LayerNorm, StackedLinear)):
        yield path, module
        return
    for name, p in module.named_parameters(recurse=False):
        yield path + (name,), p
    for name, child in module.named_children():
        yield from _layers(child, path + (_FLAX_NAME.get(name, name),))


def _to_flax(layer):
    """{flax leaf name: (torch parameter, torch layout -> flax layout,
    flax layout -> torch layout)}."""
    same = lambda a: a
    if isinstance(layer, nn.Parameter):
        return {None: (layer, same, same)}
    if isinstance(layer, nn.Linear):
        return {"kernel": (layer.weight, lambda w: w.T, lambda w: w.T), "bias": (layer.bias, same, same)}
    if isinstance(layer, nn.Conv1d):
        conv = lambda w: w.transpose(2, 1, 0)
        return {"kernel": (layer.weight, conv, conv), "bias": (layer.bias, same, same)}
    if isinstance(layer, StackedLinear):
        return {"kernel": (layer.weight, same, same), "bias": (layer.bias, same, same)}
    return {"scale": (layer.weight, same, same), "bias": (layer.bias, same, same)}


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _entries(net):
    """(flax leaf path, torch parameter, torch layout -> flax layout, back)."""
    for path, layer in _layers(net):
        for leaf, (param, fwd, inv) in _to_flax(layer).items():
            yield "/".join(path + ((leaf,) if leaf else ())), param, fwd, inv


def state_dict_from_flax(flax_params, net) -> dict:
    """`net`'s state_dict from flax params of the same architecture; a tree
    with other layers or shapes is refused."""
    p = flax_params["params"] if "params" in flax_params else flax_params
    have = {k: np.asarray(v, dtype=np.float32) for k, v in _flat(p)}
    entries = list(_entries(net))
    want = {k for k, _, _, _ in entries}
    if set(have) != want:
        raise ValueError(f"checkpoint layers differ from the network's: checkpoint only "
                         f"{sorted(set(have) - want)[:4]}, network only {sorted(want - set(have))[:4]}")
    names = {id(t): n for n, t in net.named_parameters()}
    sd = {}
    for key, param, fwd, inv in entries:
        shape = fwd(np.empty(tuple(param.shape), np.float32)).shape
        if have[key].shape != shape:
            raise ValueError(f"{key} {have[key].shape} != {shape}")
        sd[names[id(param)]] = torch.tensor(np.ascontiguousarray(inv(have[key])))
    return sd


def from_flax(flax_params, net):
    """Load flax params (a numpy dict) into `net` in place; returns it."""
    net.load_state_dict(state_dict_from_flax(flax_params, net))
    return net


def flax_params_tree(net) -> dict:
    """`net`'s weights as the flax tree under `params`, float32 numpy arrays."""
    tree: dict = {}
    for key, param, fwd, _ in _entries(net):
        *parents, leaf = key.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.array(fwd(param.detach().cpu().numpy()), order="C", copy=True)
    return tree


def flax_params(net) -> dict:
    """`net`'s weights as the flax params tree `{"params": ...}`."""
    return {"params": flax_params_tree(net)}
