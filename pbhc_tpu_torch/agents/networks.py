"""Actor networks in torch (counterpart of `pbhc_tpu/agents/networks.py`).

`MLP` and `GaussianActor` (`networks.py:18`, `:75`): an MLP mean and a
state-independent learnable std. Layer order and widths match the flax
modules, so `agents/convert.py` maps a flax checkpoint onto them one to one.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

_ACT = {"ELU": nn.ELU, "ReLU": nn.ReLU, "Tanh": nn.Tanh, "SiLU": nn.SiLU, "GELU": nn.GELU}


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int, activation: str = "ELU"):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            layers += [nn.Linear(a, b), _ACT[activation]()]
        layers.append(nn.Linear(dims[-1], out_dim))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class GaussianActor(nn.Module):
    """MLP mean + state-independent std; returns (mean, std) like the flax module."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], num_actions: int,
                 init_noise_std: float = 0.8, activation: str = "ELU"):
        super().__init__()
        self.mlp = MLP(in_dim, hidden_dims, num_actions, activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))

    def forward(self, obs):
        mean = self.mlp(obs)
        return mean, (torch.abs(self.std) + 1e-8).expand_as(mean)

    def linear_layers(self):
        return [m for m in self.mlp.net if isinstance(m, nn.Linear)]


def actor_from_config(cfg, in_dim: int, num_actions: int) -> GaussianActor:
    """The actor of `cfg.algo.config.module_dict` (as `mh_ppo.py:67-87` builds it)."""
    c = cfg.algo.config
    phase = str(c.get("phase_embed", {}).get("type", "Original"))
    if phase != "Original":
        raise NotImplementedError(f"phase_embed.type={phase!r}: phase-aware actors are "
                                  "ROADMAP queue 1 item 8")
    lc = c.module_dict.actor.layer_config
    if str(lc.get("type", "MLP")) != "MLP":
        raise NotImplementedError(f"actor type {lc.type!r} is ROADMAP queue 1 item 8")
    return GaussianActor(in_dim, tuple(lc.hidden_dims), num_actions, float(c.init_noise_std),
                         str(lc.activation))
