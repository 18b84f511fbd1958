"""Plain reference of KungfuBot2's student distillation (PPOMimic's
`dagger_only` path with a frozen teacher): the student's and the teacher's
actions through their history latents, and the behaviour-cloning update.

It builds on the mimic actor-critic of `reference/ppomimic.py` (the same
encoders, LayerNorm and backbones, read from the flax-layout pickles) and
adds what distillation changes:

- the student acts with its deterministic mean through the history latent
  (`act_mean`), in every iteration: its rollout never reads the privileged
  encoder; the critic is evaluated as in the teacher's rollout (`values`);
- the frozen teacher is a second actor-critic, built from its own run's
  snapshot and checkpoint (`teacher_checkpoint`, the configuration file's
  `teacher` block for its convolution strides), acting deterministically
  through its own history latent on its own groups: `teacher_actor_obs`
  and `teacher_future_motion_targets` in place of the actor's observation
  and future targets, and the student's proprioceptive history;
- the behaviour-cloning minibatch: the per-sample L2 norm between the
  teacher's action and the student's mean, averaged; the gradient of every
  leaf with the history encoder's set to zero; optax's global-norm clip and
  Adam at the run's lr (`reference/ppo.py`), over `num_mini_batches`
  consecutive slices of the rollout's samples, once an iteration.

`act_mean` takes any `reference/ppomimic.py` reference, so that a serving
loop holds the teacher's own run to it too.

Departures from the published description: none taken. The student's
snapshot names a teacher path under `logs/` of the machine that trained it;
the committed teacher checkpoint the configuration file names is read in
its place (its history encoder is the student's, bit for bit).
"""
from __future__ import annotations

import torch

from . import ppomimic
from .ppomimic import layer_norm, mlp
from .precision import set_full_float32

# the observation groups the student's actor and critic read
OBS_GROUPS = ppomimic.Reference.obs_groups


def act_mean(ref, obs: dict, leaves=None):
    """The deterministic action of a mimic actor (`ref`, a
    `reference/ppomimic.py` reference) through its history latent: the
    motion encoder over the future targets, the history encoder over the
    proprioceptive history, both beside the actor's observation through the
    LayerNorm into the backbone."""
    leaves = ref.start if leaves is None else leaves
    motion = ref._encode("motion_encoder", obs["future_motion_targets"], leaves)
    latent = ref.hist_latent(obs["prop_history"], leaves)
    x = layer_norm(torch.cat([obs["actor_obs"], motion, latent], dim=-1), *leaves[ref.at["ln"]])
    return mlp(x, leaves[ref.at["backbone"]], ref.precision)


class Reference(ppomimic.Reference):
    """The student's run (the configuration's snapshot and checkpoint) with
    its frozen teacher (`self.teacher`)."""

    def __init__(self, config: dict, root, device, precision: str = "float32"):
        if precision == "float32":
            set_full_float32()
        super().__init__(config, root, device, precision)
        t = config["teacher"]
        self.teacher = ppomimic.Reference({"snapshot": t["snapshot"], "checkpoint": config["teacher_checkpoint"],
                                           "actor": t["actor"]}, root, device, precision)
        a = t["actor"]
        # the student env's group that the teacher reads in place of each of its own
        self.teacher_groups = {"actor_obs": a["group"], "future_motion_targets": a["motion_encoder"]["group"],
                               "prop_history": a["history_encoder"]["group"]}

    def _set_iteration(self, iteration: int):
        super()._set_iteration(iteration)
        # a distillation rollout acts through the history latent in every iteration
        self.rollout_history = True

    # ------------------------------------------------------------- networks
    def act_mean(self, obs: dict, leaves=None):
        return act_mean(self, obs, leaves)

    def teacher_actions(self, obs: dict):
        """The frozen teacher's deterministic action on the student env's
        teacher groups (`obs` holds them under their own names)."""
        return act_mean(self.teacher, {k: obs[g] for k, g in self.teacher_groups.items()})

    # -------------------------------------------------------------- learner
    def loss_weights(self) -> dict:
        return {"bc": 1.0}

    def follow_bc(self, samples: dict, steps: int, start, opt: dict, lr: float) -> dict:
        """The first `steps` behaviour-cloning minibatches of an iteration's
        pass over `samples` (flat [S, ...]: the student's groups and
        `teacher_actions`), from the leaves `start` and the Adam state `opt`
        (`count`, `mu`, `nu`), all in flax's layouts, at the fixed `lr`.
        Returns each step's loss, the first step's clipped gradients and the
        leaves before and after."""
        S = samples["teacher_actions"].shape[0]
        mb = S // self.num_minibatches
        params = [p.clone().requires_grad_(True) for p in start]
        state = {"count": int(opt["count"]), "mu": [m.clone() for m in opt["mu"]],
                 "nu": [v.clone() for v in opt["nu"]]}
        frozen = set(self.history_leaves)
        losses, first_grads = [], None
        for k in range(steps):
            rows = slice(k * mb, (k + 1) * mb)
            student = self.act_mean({g: samples[g][rows] for g in OBS_GROUPS}, params)
            loss = torch.linalg.vector_norm(samples["teacher_actions"][rows] - student, dim=-1).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None or i in frozen else g
                     for i, (g, p) in enumerate(zip(grads, params))]
            clipped = self.adam(params, grads, state, lr)
            if k == 0:
                first_grads = clipped
            losses.append({"bc": loss.detach()})
        return {"losses": losses, "first_grads": first_grads, "start": list(start),
                "params": [p.detach() for p in params]}
