"""Plain reference of KungfuBot2's policy and learner (PPOMimic): the mimic
actor-critic, the RL minibatch update with `priv_reg`, and the DAgger pass.

The actor: a motion encoder over the future targets and, in the RL update,
a privileged MLP encoder (or, in the rollout of every `dagger_update_freq`-th
iteration, a history encoder over the proprioceptive history), their latents
beside the actor's observation through a LayerNorm into a SiLU MLP; a global
sigma clipped to [min_sigma, max_sigma]. An encoder of steps is a Dense per
step with a ReLU, strided convolutions over time with VALID padding, each
with a SiLU, and a Dense over the time-major flattened output. The critic
reruns the motion encoder and reads the actor's and the privileged
observation through its own LayerNorm into a SiLU MLP with one value.

The RL update is PPO's (`reference/ppo.py`) on the privileged latent plus
`priv_reg`: the mean distance between the privileged latent and the
history latent (no gradient through the latter), weighted by the staged
coefficient `clip((iteration - s2) / s3, 0, 1) * (s1 - s0) + s0` in
float32; one Adam over every parameter with the adaptive lr. The DAgger
pass fits the history latent to the privileged one (no gradient) over
`num_mini_batches` consecutive slices of the rollout's samples, with an Adam
of its own over the history encoder at the fixed `learning_rate`.

It reads the committed run's config snapshot and checkpoint pickle itself
(flax layout: `Dense_i/kernel` [in, out], `Conv_i/kernel` [k, in, out],
LayerNorm `scale`/`bias`, with flax's epsilon 1e-6 and its variance
E[x^2] - E[x]^2 clipped at 0); the convolutions' strides, which the
checkpoint does not hold, are the configuration file's. Departures from the
published description: none taken; MoE backbones are not followed.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .ppo import PPOReference, dense_leaves
from .precision import matmul

LN_EPS = 1e-6


def silu(x):
    return x * torch.sigmoid(x)


def mlp(x, leaves, precision):
    """Dense layers with a SiLU between them."""
    n = len(leaves) // 2
    for i in range(n):
        x = matmul(x, leaves[2 * i], precision) + leaves[2 * i + 1]
        if i < n - 1:
            x = silu(x)
    return x


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def encoder(x, leaves, steps: int, strides, precision):
    """[B, steps * per_step] (step-major) -> [B, out]; `leaves` the Dense_0,
    Conv_i and Dense_1 kernels and biases in that order."""
    B = x.shape[0]
    h = torch.relu(matmul(x.reshape(B, steps, -1), leaves[0], precision) + leaves[1])
    for i, s in enumerate(strides):
        k, b = leaves[2 + 2 * i], leaves[3 + 2 * i]
        width = k.shape[0]
        out = (h.shape[1] - width) // s + 1
        windows = torch.stack([h[:, j * s:j * s + width] for j in range(out)], dim=1)
        h = silu(matmul(windows.reshape(B, out, -1), k.reshape(-1, k.shape[-1]), precision) + b)
    return matmul(h.reshape(B, -1), leaves[-2], precision) + leaves[-1]


def _encoder_leaves(tree) -> list:
    convs = len([k for k in tree if k.startswith("Conv_")])
    names = ["Dense_0", *(f"Conv_{i}" for i in range(convs)), "Dense_1"]
    return [a for n in names for a in (tree[n]["kernel"], tree[n]["bias"])]


class Reference(PPOReference):
    obs_groups = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")

    def __init__(self, config: dict, root, device, precision: str = "float32"):
        super().__init__(config, root, device, precision)
        a = self.snapshot["algo"]["config"]
        md = a["module_dict"]
        if any(md[m]["layer_config"].get("type", "MLP") != "MLP" for m in ("actor", "critic")):
            raise NotImplementedError("the reference follows MLP backbones")
        self.min_sigma, self.max_sigma = float(md["actor"]["min_sigma"]), float(md["actor"]["max_sigma"])
        self.learning_rate = float(a["learning_rate"])
        self.schedule = np.asarray([float(x) for x in a["priv_reg_coef_schedual"]], dtype=np.float32)
        self.dagger_freq = int(a["dagger_update_freq"])
        self._set_iteration(self.iteration)
        enc = config["actor"]
        self.plans = {name: (int(md["actor"][name]["tsteps"]), enc[name]["strides"])
                      for name in ("motion_encoder", "history_encoder")}
        p = self.payload["params"]["params"]
        # leaves in the order the program's optimizer holds them: the sigma,
        # the actor's motion, history and privileged encoders, its backbone and
        # LayerNorm, then the critic's MLP and LayerNorm
        groups = [("std", [p["std"]]),
                  ("motion_encoder", _encoder_leaves(p["actor"]["motion_encoder"])),
                  ("history_encoder", _encoder_leaves(p["actor"]["history_encoder"])),
                  ("priv_encoder", dense_leaves(p["actor"]["priv_encoder"])),
                  ("backbone", dense_leaves(p["actor"]["backbone"])),
                  ("ln", [p["actor"]["ln"]["scale"], p["actor"]["ln"]["bias"]]),
                  ("critic", dense_leaves(p["critic"])),
                  ("critic_ln", [p["critic_ln"]["scale"], p["critic_ln"]["bias"]])]
        self.start, self.at = [], {}
        for name, leaves in groups:
            self.at[name] = slice(len(self.start), len(self.start) + len(leaves))
            self.start += [self.tensor(x) for x in leaves]
        for name in self.plans:
            kernels = [int(k.shape[0]) for k in self.start[self.at[name]][2:-2:2]]
            if kernels != enc[name]["kernels"]:
                raise ValueError(f"the checkpoint's {name} kernels {kernels} are not the configuration file's")
        self.history_leaves = list(range(len(self.start)))[self.at["history_encoder"]]
        self.groups = [("loss", list(range(len(self.start))))]

    def _set_iteration(self, iteration: int):
        s = self.schedule
        stage = np.clip((np.float32(iteration) - s[2]) / s[3], np.float32(0), np.float32(1))
        self.iteration, self.priv_reg_coef = iteration, float(stage * (s[1] - s[0]) + s[0])
        # the iteration's rollout acts through the history latent when it is an rl+dagger one
        self.rollout_history = self.dagger_freq > 0 and iteration % self.dagger_freq == 0

    def restarted(self, start, lr: float, iteration: int) -> "Reference":
        """A copy that follows the update phase of a later iteration: from
        the parameters `start` (in the program's order and layouts), the lr
        `lr` and fresh Adam moments, with `iteration`'s `priv_reg`
        coefficient and rollout latent."""
        ref = copy.copy(self)
        ref.start = [t.to(device=self.device, dtype=torch.float32) for t in self.from_program(start)]
        ref.lr0 = lr
        ref._set_iteration(iteration)
        return ref

    # ------------------------------------------------------------- networks
    def _encode(self, name, x, leaves):
        steps, strides = self.plans[name]
        return encoder(x, leaves[self.at[name]], steps, strides, self.precision)

    def priv_latent(self, priv_obs, leaves):
        return mlp(priv_obs, leaves[self.at["priv_encoder"]], self.precision)

    def hist_latent(self, prop_history, leaves):
        return self._encode("history_encoder", prop_history, leaves)

    def policy(self, obs: dict, leaves, rollout=False):
        motion = self._encode("motion_encoder", obs["future_motion_targets"], leaves)
        latent = self.hist_latent(obs["prop_history"], leaves) if rollout and self.rollout_history \
            else self.priv_latent(obs["priv_obs"], leaves)
        ln = leaves[self.at["ln"]]
        x = layer_norm(torch.cat([obs["actor_obs"], motion, latent], dim=-1), *ln)
        mean = mlp(x, leaves[self.at["backbone"]], self.precision)
        std = torch.clamp(torch.abs(leaves[self.at["std"]][0]), self.min_sigma, self.max_sigma)
        return mean, std.expand_as(mean)

    def values(self, obs: dict, leaves):
        motion = self._encode("motion_encoder", obs["future_motion_targets"], leaves)
        ln = leaves[self.at["critic_ln"]]
        x = layer_norm(torch.cat([obs["actor_obs"], obs["priv_obs"], motion], dim=-1), *ln)
        return mlp(x, leaves[self.at["critic"]], self.precision)

    # -------------------------------------------------------------- learner
    def loss_weights(self) -> dict:
        return {**super().loss_weights(), "priv_reg": self.priv_reg_coef}

    def minibatch(self, params, obs, rows):
        mean, std = self.policy(obs, params)
        terms = self.ppo_terms(mean, std, self.values(obs, params), rows)
        with torch.no_grad():
            hist = self.hist_latent(obs["prop_history"], params)
        terms["priv_reg"] = torch.linalg.vector_norm(self.priv_latent(obs["priv_obs"], params) - hist, dim=-1).mean()
        loss = sum(w * terms[k] for k, w in self.loss_weights().items())
        return terms, {"loss": loss}

    @staticmethod
    def from_program(leaves) -> list:
        """Leaves in torch's layouts (a Linear's weight [out, in], a
        Conv1d's [out, in, k]) in the flax layout this reference reads."""
        return [t.T if t.dim() == 2 else t.permute(2, 1, 0) if t.dim() == 3 else t for t in leaves]

    def dagger(self, rollout: dict, start) -> dict:
        """The DAgger pass over `rollout`'s samples (priv_obs, prop_history
        [T,N,*]) from the parameters `start` (every leaf, as the program's
        optimizer holds them when the pass begins, in flax's layout). Returns each
        minibatch's loss and the history encoder's leaves before and after."""
        T, N = rollout["priv_obs"].shape[:2]
        priv = rollout["priv_obs"].reshape(T * N, -1)
        hist = rollout["prop_history"].reshape(T * N, -1)
        leaves = list(start)
        for i in self.history_leaves:
            leaves[i] = start[i].clone().requires_grad_(True)
        moving = [leaves[i] for i in self.history_leaves]
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in moving],
                 "nu": [torch.zeros_like(p) for p in moving]}
        mb = T * N // self.num_minibatches
        losses = []
        for k in range(self.num_minibatches):
            rows = slice(k * mb, (k + 1) * mb)
            with torch.no_grad():
                target = self.priv_latent(priv[rows], leaves)
            loss = torch.linalg.vector_norm(self.hist_latent(hist[rows], leaves) - target, dim=-1).mean()
            self.adam(moving, list(torch.autograd.grad(loss, moving)), state, self.learning_rate)
            losses.append(loss.detach())
        return {"losses": losses, "start": [start[i] for i in self.history_leaves],
                "params": [p.detach() for p in moving]}
