"""Actor and critic networks in torch (counterpart of `pbhc_tpu/agents/networks.py`).

`MLP`, `GaussianActor` (an MLP mean and a state-independent learnable std),
`Critic` (one value per reward head), a `LayerNorm` with flax's numerics
and the gaussian helpers (`networks.py:18`, `:75-98`, `:170-176`). Layer
order and widths match the flax modules, so `agents/convert.py` maps flax
params onto them one to one, and `flax_init_` draws fresh weights as flax's
`Dense`, `Conv` and `LayerNorm` do.
"""
from __future__ import annotations

import math
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

    def linear_layers(self):
        return [m for m in self.net if isinstance(m, nn.Linear)]


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm` over the last axis: epsilon 1e-6 and the "fast"
    variance E[x^2] - E[x]^2 clipped at 0, then
    (x - mean) * (rsqrt(var + eps) * scale) + bias, in flax's order of
    operations. `weight` is flax's `scale`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GaussianActor(nn.Module):
    """MLP mean + state-independent std; returns (mean, std) like the flax module."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], num_actions: int,
                 init_noise_std: float = 0.8, activation: str = "ELU"):
        super().__init__()
        self.mlp = MLP(in_dim, hidden_dims, num_actions, activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        # the flax module's fields, which the ONNX writer reads
        self.num_actions, self.activation = num_actions, activation

    def forward(self, obs):
        mean = self.mlp(obs)
        return mean, (torch.abs(self.std) + 1e-8).expand_as(mean)

    def linear_layers(self):
        return self.mlp.linear_layers()


class Critic(nn.Module):
    """MLP with one value output per reward head (`networks.py:91`)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], num_values: int,
                 activation: str = "ELU"):
        super().__init__()
        self.mlp = MLP(in_dim, hidden_dims, num_values, activation)

    def forward(self, obs):
        return self.mlp(obs)

    def linear_layers(self):
        return self.mlp.linear_layers()


def flax_init_(net, generator: torch.Generator):
    """Fresh weights as flax draws them, module by module in registration
    order: `Dense` and `Conv` kernels lecun_normal (a normal truncated at two
    standard deviations, scaled to variance 1/fan_in, fan_in = in_features,
    or in_channels x kernel size for a Conv) and zero biases; `LayerNorm`
    scale ones and bias zeros. A network's `std` keeps its constructor value
    (`init_noise_std`)."""
    for m in net.modules():
        with torch.no_grad():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                # 0.8796... is the std of a unit normal truncated to [-2, 2]
                # (jax.nn.initializers.variance_scaling, "truncated_normal")
                sd = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=sd, a=-2.0 * sd, b=2.0 * sd, generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return net


def gaussian_log_prob(mean, std, actions):
    """Sum over the action axis (`networks.py:170`)."""
    var = std ** 2
    return (-0.5 * ((actions - mean) ** 2) / var - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(-1)


def gaussian_entropy(std):
    """Sum over the action axis (`networks.py:175`)."""
    return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)).sum(-1)


def _layer_config(cfg, which):
    c = cfg.algo.config
    phase = str(c.get("phase_embed", {}).get("type", "Original"))
    if phase != "Original":
        raise NotImplementedError(f"phase_embed.type={phase!r}: phase-aware networks are "
                                  "ROADMAP queue 1 item 8")
    lc = c.module_dict[which].layer_config
    if str(lc.get("type", "MLP")) != "MLP":
        raise NotImplementedError(f"{which} type {lc.type!r} is ROADMAP queue 1 item 8")
    return lc


def actor_from_config(cfg, in_dim: int, num_actions: int) -> GaussianActor:
    """The actor of `cfg.algo.config.module_dict` (as `mh_ppo.py:67-87` builds it)."""
    lc = _layer_config(cfg, "actor")
    return GaussianActor(in_dim, tuple(lc.hidden_dims), num_actions,
                         float(cfg.algo.config.init_noise_std), str(lc.activation))


def critic_from_config(cfg, in_dim: int, num_values: int) -> Critic:
    """The critic of `cfg.algo.config.module_dict` (`mh_ppo.py:87`)."""
    lc = _layer_config(cfg, "critic")
    return Critic(in_dim, tuple(lc.hidden_dims), num_values, str(lc.activation))
