"""Plain reference of KungfuBot v1's policy and learner (MHPPO): an ELU MLP
actor with a state-independent std, an ELU MLP critic with one value per
reward head, and two Adam optimizers (actor, critic) sharing the adaptive lr.

It reads the committed run's config snapshot and checkpoint pickle itself
(flax layout: `Dense_i/kernel` [in, out]) and works out again everything the
program derives from them (`reference/ppo.py`). What it takes from the
program are its inputs and outputs only: the observations, sampled actions,
rewards, dones and timeouts of the rollout, and the order in which the first
epoch visits the samples.
"""
from __future__ import annotations

import torch

from .ppo import PPOReference, dense_leaves
from .precision import matmul


def mlp(x, leaves, precision, act=torch.nn.functional.elu):
    n = len(leaves) // 2
    for i in range(n):
        x = matmul(x, leaves[2 * i], precision) + leaves[2 * i + 1]
        if i < n - 1:
            x = act(x)
    return x


class Reference(PPOReference):
    obs_groups = ("actor_obs", "critic_obs")

    def __init__(self, config: dict, root, device, precision: str = "float32"):
        super().__init__(config, root, device, precision)
        p = self.payload
        # leaves in the order the program's optimizers hold them: the std, the
        # actor MLP, then the critic MLP
        actor = [p["actor_params"]["params"]["std"], *dense_leaves(p["actor_params"]["params"]["MLP_0"])]
        critic = dense_leaves(p["critic_params"]["params"]["MLP_0"])
        self.start = [self.tensor(a) for a in actor + critic]
        self._na = len(actor)
        self.groups = [("actor_loss", list(range(self._na))),
                       ("critic_loss", list(range(self._na, len(self.start))))]

    def policy(self, obs: dict, leaves, rollout=False):
        mean = mlp(obs["actor_obs"], leaves[1:self._na], self.precision)
        return mean, (torch.abs(leaves[0]) + 1e-8).expand_as(mean)

    def values(self, obs: dict, leaves):
        return mlp(obs["critic_obs"], leaves[self._na:], self.precision)

    def act_mean(self, obs: dict):
        return self.policy(obs, self.start)[0]

    def minibatch(self, params, obs, rows):
        mean, std = self.policy(obs, params)
        terms = self.ppo_terms(mean, std, self.values(obs, params), rows)
        return terms, {"actor_loss": terms["surrogate"] - self.entropy_coef * terms["entropy"],
                       "critic_loss": self.value_loss_coef * terms["value_loss"]}
