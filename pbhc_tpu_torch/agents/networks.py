"""Actor and critic networks in torch (counterpart of `pbhc_tpu/agents/networks.py`).

`MLP`, `MoEMLP` (every expert as one stacked computation, top-k softmax
gating and the Switch load-balance loss), `GaussianActor` (an MLP mean and a
state-independent learnable std), `Critic` (one value per reward head),
`PhaseEmbed` with `PhaseAwareActor` and `PhaseAwareCritic`, `Estimator`, a
`LayerNorm` with flax's numerics and the gaussian helpers (`networks.py:18-176`).
Layer order and widths match the flax modules, so `agents/convert.py` maps
flax params onto them one to one, and `flax_init_` draws fresh weights as
flax's `Dense`, `Conv` and `LayerNorm` do.
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


class StackedLinear(nn.Module):
    """E independent `Dense` layers applied as one batched product: `weight`
    [E, in, out] and `bias` [E, out] in flax's layout (`nn.vmap` over `Dense`
    stacks each leaf on axis 0). x [N, in] (every expert sees it) or
    [N, E, in] -> [N, E, out]."""

    def __init__(self, num: int, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(num, out_dim))

    def forward(self, x):
        eq = "ni,eio->neo" if x.dim() == 2 else "nei,eio->neo"
        return torch.einsum(eq, x, self.weight) + self.bias


class MoEMLP(nn.Module):
    """Dense-gated mixture of experts (`networks.py:31-72`). Every expert is
    evaluated on every sample as one stacked MLP (`experts`, weights
    [E, in, h] per layer, one batched product per layer); a `gate` Dense gives
    softmax probabilities, the top `top_k` are renormalised and mix the
    experts' outputs through a one-hot dispatch. Returns (output, the Switch
    load-balance loss E * sum_e f_e * P_e), the loss that flax sows. Given
    `dp`, a (`parallel/mesh.py::EnvShard`, global minibatch rows) pair, `f` is
    the minibatch mean over every rank (no gradient flows through the one-hot
    dispatch) and `P` this rank's share of it, so that the ranks' losses sum
    to the global loss."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int, num_experts: int = 4,
                 top_k: int = 2, activation: str = "ELU"):
        super().__init__()
        dims = [in_dim, *hidden_dims, out_dim]
        self.experts = nn.ModuleList(StackedLinear(num_experts, a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.gate = nn.Linear(in_dim, num_experts)
        self.act = _ACT[activation]()
        self.num_experts, self.top_k = num_experts, top_k

    def forward(self, x, dp=None):
        E, K = self.num_experts, self.top_k
        h = x
        for i, layer in enumerate(self.experts):
            h = layer(h)
            if i < len(self.experts) - 1:
                h = self.act(h)                                       # [N,E,out] at the end
        probs = torch.softmax(self.gate(x), dim=-1)                   # [N,E]
        top_vals, top_idx = torch.topk(probs, K, dim=-1)
        weights = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
        dispatch = nn.functional.one_hot(top_idx, E).to(probs.dtype)  # [N,K,E]
        combine = (weights[..., None] * dispatch).sum(1)              # [N,E]
        out = torch.einsum("ne,neo->no", combine, h)
        if dp is None:
            f, p = dispatch.sum(1).mean(0) / K, probs.mean(0)
        else:
            shard, rows = dp
            f, p = shard.global_mean0(dispatch.sum(1), rows) / K, shard.share0(probs, rows)
        return out, E * torch.sum(f * p)


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


class PhaseEmbed(nn.Module):
    """Embedding of the phase scalar (`networks.py:100-117`): `Sinusoidal`
    [sin(2^k pi p), cos(2^k pi p)] for k < dim // 2, or `Learnable`, a Dense
    of width `dim` (flax's `PhaseEmbed_0/Dense_0`)."""

    def __init__(self, embed_type: str = "Sinusoidal", dim: int = 16):
        super().__init__()
        if embed_type not in ("Sinusoidal", "Learnable"):
            raise ValueError(f"unknown phase_embed.type {embed_type!r}")
        self.embed_type, self.dim = embed_type, int(dim)
        if embed_type == "Learnable":
            self.Dense_0 = nn.Linear(1, self.dim)
        else:
            self.register_buffer("freqs", (2.0 ** torch.arange(self.dim // 2)) * math.pi, persistent=False)

    @property
    def out_dim(self) -> int:
        return self.dim if self.embed_type == "Learnable" else 2 * (self.dim // 2)

    def forward(self, phase):                                       # [..., 1]
        if self.embed_type == "Learnable":
            return self.Dense_0(phase)
        ang = phase * self.freqs
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class PhaseAwareActor(nn.Module):
    """`GaussianActor` fed [obs, PhaseEmbed(obs[phase_pos])] (`networks.py:120`)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], num_actions: int, phase_pos: int,
                 init_noise_std: float = 0.8, activation: str = "ELU", embed_type: str = "Sinusoidal",
                 embed_dim: int = 16):
        super().__init__()
        self.phase_embed = PhaseEmbed(embed_type, embed_dim)
        self.mlp = MLP(in_dim + self.phase_embed.out_dim, hidden_dims, num_actions, activation)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        # the flax module's fields, which the ONNX writer reads
        self.num_actions, self.activation, self.phase_pos = num_actions, activation, int(phase_pos)
        self.embed_type, self.embed_dim = embed_type, int(embed_dim)

    def forward(self, obs):
        emb = self.phase_embed(obs[..., self.phase_pos:self.phase_pos + 1])
        mean = self.mlp(torch.cat([obs, emb], dim=-1))
        return mean, (torch.abs(self.std) + 1e-8).expand_as(mean)


class PhaseAwareCritic(nn.Module):
    """`Critic` fed [obs, PhaseEmbed(obs[phase_pos])] (`networks.py:141`)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], num_values: int, phase_pos: int,
                 activation: str = "ELU", embed_type: str = "Sinusoidal", embed_dim: int = 16):
        super().__init__()
        self.phase_embed = PhaseEmbed(embed_type, embed_dim)
        self.mlp = MLP(in_dim + self.phase_embed.out_dim, hidden_dims, num_values, activation)
        self.phase_pos = int(phase_pos)

    def forward(self, obs):
        emb = self.phase_embed(obs[..., self.phase_pos:self.phase_pos + 1])
        return self.mlp(torch.cat([obs, emb], dim=-1))


class Estimator(nn.Module):
    """An MLP from a proprioceptive history to a privileged estimate
    (`networks.py:156`); the JAX package has no consumer of it either."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int, activation: str = "ELU"):
        super().__init__()
        self.mlp = MLP(in_dim, hidden_dims, out_dim, activation)

    def forward(self, obs_history):
        return self.mlp(obs_history)


def flax_init_(net, generator: torch.Generator):
    """Fresh weights as flax draws them, module by module in registration
    order: `Dense` and `Conv` kernels lecun_normal (a normal truncated at two
    standard deviations, scaled to variance 1/fan_in, fan_in = in_features,
    or in_channels x kernel size for a Conv, or a stacked expert layer's
    input width) and zero biases; `LayerNorm` scale ones and bias zeros. A
    network's `std` keeps its constructor value (`init_noise_std`)."""
    for m in net.modules():
        with torch.no_grad():
            if isinstance(m, (nn.Linear, nn.Conv1d, StackedLinear)):
                fan_in = m.weight.shape[1] if isinstance(m, StackedLinear) else m.weight[0].numel()
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


def phase_embed_config(cfg):
    """(type, dim) of `algo.config.phase_embed`; type "Original" feeds the raw phase."""
    pe = cfg.algo.config.get("phase_embed", {})
    return str(pe.get("type", "Original")), int(pe.get("dim", 16))


def phase_position(env, group) -> int:
    """Start of `ref_motion_phase` in obs group `group` (`mh_ppo.py:77-82`)."""
    return env.obs_key_slices(group)["ref_motion_phase"][0]


def actor_from_config(cfg, in_dim: int, num_actions: int, phase_pos: int | None = None):
    """The actor of `cfg.algo.config.module_dict` (as `mh_ppo.py:67-87` builds
    it): a `PhaseAwareActor` when `phase_embed.type` is not "Original", which
    needs the phase's position `phase_pos` in the actor obs. As there, the
    layer config's `type` is not read: MHPPO's networks are MLPs."""
    lc = cfg.algo.config.module_dict.actor.layer_config
    args = (in_dim, tuple(lc.hidden_dims), num_actions)
    kind, dim = phase_embed_config(cfg)
    if kind == "Original":
        return GaussianActor(*args, float(cfg.algo.config.init_noise_std), str(lc.activation))
    if phase_pos is None:
        raise ValueError("a phase-aware actor needs the phase's position in its obs")
    return PhaseAwareActor(*args, phase_pos, float(cfg.algo.config.init_noise_std), str(lc.activation),
                           kind, dim)


def critic_from_config(cfg, in_dim: int, num_values: int, phase_pos: int | None = None):
    """The critic of `cfg.algo.config.module_dict` (`mh_ppo.py:80-87`)."""
    lc = cfg.algo.config.module_dict.critic.layer_config
    kind, dim = phase_embed_config(cfg)
    if kind == "Original":
        return Critic(in_dim, tuple(lc.hidden_dims), num_values, str(lc.activation))
    if phase_pos is None:
        raise ValueError("a phase-aware critic needs the phase's position in its obs")
    return PhaseAwareCritic(in_dim, tuple(lc.hidden_dims), num_values, phase_pos, str(lc.activation), kind, dim)
