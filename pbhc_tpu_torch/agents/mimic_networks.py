"""Teacher-student (KungfuBot2) networks in torch (counterpart of
`pbhc_tpu/agents/mimic_networks.py`).

`ConvEncoder` (per-step Linear, two Conv1d over time, Linear head), the
`MimicActor` (motion encoder over the future targets, history encoder over
the proprioceptive history, a priv MLP encoder, LayerNorm, MLP backbone) and
`MimicActorCritic` (the actor, an MLP critic behind its own LayerNorm, and a
global sigma clipped to [min_sigma, max_sigma]). Either backbone may be a
`MoEMLP` (`mimic_networks.py:20-27`); `act_lb` and `evaluate_lb` then also
return the load-balance losses of the experts they ran, which flax sows
(`ppo_mimic.py:227-234` sums them), 0 for MLP backbones; given `dp`, a
(`parallel/mesh.py::EnvShard`, global minibatch rows) pair, this rank's
share of them.

Every submodule carries its flax name (`Dense_0`, `Conv_0`, `ln`, ...), so
`agents/convert.py` maps the flax tree onto it by path. Flax's `nn.Conv`
runs over [N, T, C] with VALID padding; `nn.Conv1d` over [N, C, T], so the
encoder transposes in and out and flattens time-major as flax does.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pbhc_tpu_torch.agents.networks import _ACT, MLP, LayerNorm, MoEMLP

_CONV_PLANS = {  # `mimic_networks.py:29-33`
    5: dict(out_channels=[20, 10], kernels=[2, 2], strides=[1, 1]),
    10: dict(out_channels=[20, 10], kernels=[4, 2], strides=[2, 1]),
    20: dict(out_channels=[40, 20], kernels=[6, 4], strides=[2, 2]),
}


def _backbone(kind: str, in_dim, hidden_dims, out_dim, activation, num_experts: int = 4, top_k: int = 2):
    """`mimic_networks.py:20`: an `MLP` or a `MoEMLP`."""
    if kind == "MoEMLP":
        return MoEMLP(in_dim, hidden_dims, out_dim, num_experts, top_k, activation)
    if kind != "MLP":
        raise ValueError(f"unknown backbone type {kind!r}")
    return MLP(in_dim, hidden_dims, out_dim, activation)


def _with_lb(backbone, x, dp=None):
    """(output, load-balance loss) of a backbone; 0 for an MLP."""
    if isinstance(backbone, MoEMLP):
        return backbone(x, dp)
    return backbone(x), x.new_zeros(())


class ConvEncoder(nn.Module):
    """[N, tsteps * per_step_dim] (step-major) -> [N, output_dim] (`mimic_networks.py:36`)."""

    def __init__(self, tsteps: int, per_step_dim: int, hidden_dim: int, output_dim: int,
                 activation: str = "SiLU"):
        super().__init__()
        plan = _CONV_PLANS[tsteps]
        self.tsteps, self.per_step_dim = tsteps, per_step_dim
        self.Dense_0 = nn.Linear(per_step_dim, hidden_dim)
        chans, t = [hidden_dim, *plan["out_channels"]], tsteps
        for i, (k, s) in enumerate(zip(plan["kernels"], plan["strides"])):
            setattr(self, f"Conv_{i}", nn.Conv1d(chans[i], chans[i + 1], k, stride=s))
            t = (t - k) // s + 1
        self.num_convs = len(plan["kernels"])
        self.Dense_1 = nn.Linear(t * chans[-1], output_dim)
        self.act = _ACT[activation]()

    def forward(self, x):
        N = x.shape[0]
        x = torch.relu(self.Dense_0(x.reshape(N, self.tsteps, self.per_step_dim))).transpose(1, 2)
        for i in range(self.num_convs):
            x = self.act(getattr(self, f"Conv_{i}")(x))
        return self.Dense_1(x.transpose(1, 2).reshape(N, -1))


class MimicActor(nn.Module):
    """`mimic_networks.py:62`; the input widths torch needs are given."""

    def __init__(self, actor_dim: int, priv_dim: int, hidden_dims: Sequence[int], num_actions: int,
                 future_steps: int, future_per_step: int, history_steps: int, history_per_step: int,
                 motion_latent: int = 128, hist_latent: int = 64, motion_hidden: int = 60,
                 history_hidden: int = 30, priv_hidden: Sequence[int] = (64,), activation: str = "SiLU",
                 backbone_type: str = "MLP", num_experts: int = 4, top_k: int = 2):
        super().__init__()
        self.motion_encoder = ConvEncoder(future_steps, future_per_step, motion_hidden, motion_latent, activation)
        self.history_encoder = ConvEncoder(history_steps, history_per_step, history_hidden, hist_latent,
                                           activation)
        self.priv_encoder = MLP(priv_dim, tuple(priv_hidden), hist_latent, activation)
        in_dim = actor_dim + motion_latent + hist_latent
        self.backbone = _backbone(backbone_type, in_dim, tuple(hidden_dims), num_actions, activation,
                                  num_experts, top_k)
        self.ln = LayerNorm(in_dim)

    def forward_lb(self, obs, hist_encoding: bool, dp=None):
        """(mean action, the backbone's load-balance loss)."""
        motion = self.motion_encoder(obs["future_motion_targets"])
        latent = (self.history_encoder(obs["prop_history"]) if hist_encoding
                  else self.priv_encoder(obs["priv_obs"]))
        return _with_lb(self.backbone, self.ln(torch.cat([obs["actor_obs"], motion, latent], dim=-1)), dp)

    def forward(self, obs, hist_encoding: bool):
        return self.forward_lb(obs, hist_encoding)[0]


class MimicActorCritic(nn.Module):
    """Actor, critic and clipped global sigma (`mimic_networks.py:111`)."""

    def __init__(self, actor_dim: int, priv_dim: int, actor_hidden: Sequence[int],
                 critic_hidden: Sequence[int], num_actions: int, num_values: int,
                 future_steps: int, future_per_step: int, history_steps: int, history_per_step: int,
                 init_noise_std: float = 1.0, min_sigma: float = 0.2, max_sigma: float = 1.2,
                 activation: str = "SiLU", actor_type: str = "MLP", critic_type: str = "MLP",
                 num_experts: int = 4, top_k: int = 2):
        super().__init__()
        self.actor = MimicActor(actor_dim, priv_dim, actor_hidden, num_actions, future_steps,
                                future_per_step, history_steps, history_per_step,
                                activation=activation, backbone_type=actor_type,
                                num_experts=num_experts, top_k=top_k)
        critic_in = actor_dim + priv_dim + self.actor.motion_encoder.Dense_1.out_features
        self.critic = _backbone(critic_type, critic_in, tuple(critic_hidden), num_values, activation,
                                num_experts, top_k)
        self.critic_ln = LayerNorm(critic_in)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        self.min_sigma, self.max_sigma = float(min_sigma), float(max_sigma)
        # the flax module's fields, which the ONNX writer reads
        self.future_steps, self.future_per_step = future_steps, future_per_step
        self.history_steps, self.history_per_step = history_steps, history_per_step
        self.activation, self.num_actions = activation, num_actions

    def act_lb(self, obs, hist_encoding: bool = False, dp=None):
        """((mean, std), the actor backbone's load-balance loss)."""
        mean, lb = self.actor.forward_lb(obs, hist_encoding, dp)
        std = torch.clamp(torch.abs(self.std), self.min_sigma, self.max_sigma)
        return (mean, std.expand_as(mean)), lb

    def act(self, obs, hist_encoding: bool = False):
        return self.act_lb(obs, hist_encoding)[0]

    def evaluate_lb(self, obs, dp=None):
        """(values, the critic backbone's load-balance loss)."""
        motion = self.actor.motion_encoder(obs["future_motion_targets"])
        return _with_lb(self.critic, self.critic_ln(torch.cat([obs["actor_obs"], obs["priv_obs"], motion], dim=-1)),
                        dp)

    def evaluate(self, obs):
        return self.evaluate_lb(obs)[0]

    def priv_latent(self, priv_obs):
        return self.actor.priv_encoder(priv_obs)

    def hist_latent(self, prop_history):
        return self.actor.history_encoder(prop_history)


def build_mimic_net(algo_cfg, num_act: int, actor_dim: int, priv_dim: int, future_dim: int,
                    future_steps: int, history_dim: int, history_steps: int) -> MimicActorCritic:
    """The actor-critic of an algo config subtree (`ppo_mimic.py:55`), shared by
    `PPOMimic` and the frozen-teacher loader (which builds it from the
    teacher's own config)."""
    a_cfg, v_cfg = algo_cfg.module_dict.actor, algo_cfg.module_dict.critic
    return MimicActorCritic(
        actor_dim, priv_dim,
        actor_hidden=tuple(a_cfg.layer_config.hidden_dims),
        critic_hidden=tuple(v_cfg.layer_config.hidden_dims),
        num_actions=num_act, num_values=1,
        future_steps=future_steps, future_per_step=future_dim // future_steps,
        history_steps=history_steps, history_per_step=history_dim // history_steps,
        init_noise_std=float(algo_cfg.init_noise_std),
        min_sigma=float(a_cfg.get("min_sigma", 0.2)), max_sigma=float(a_cfg.get("max_sigma", 1.2)),
        activation=a_cfg.layer_config.activation,
        actor_type=str(a_cfg.layer_config.get("type", "MLP")),
        critic_type=str(v_cfg.layer_config.get("type", "MLP")),
        # both backbones take the actor's expert counts, as `ppo_mimic.py:77-78` does
        num_experts=int(a_cfg.layer_config.get("num_experts", 4)),
        top_k=int(a_cfg.layer_config.get("top_k", 2)))


def mimic_net_from_config(cfg, num_act: int) -> MimicActorCritic:
    """`build_mimic_net` for a run config, its widths read off `cfg.obs`."""
    from pbhc_tpu_torch.envs.tracking_env import obs_width

    o = cfg.obs
    return build_mimic_net(cfg.algo.config, num_act, obs_width(o, "actor_obs"), obs_width(o, "priv_obs"),
                           obs_width(o, "future_motion_targets"), int(o.future_num_steps),
                           obs_width(o, "prop_history"), int(o.history_length))
