"""What the plain references of the PPO learners share: the run's config and
checkpoint read from disk, the observation of the last action, per-head GAE
with normalised advantages, the clipped surrogate and value loss, the
adaptive-KL learning rate, optax's global-norm clip and Adam, and the loop
that follows the first minibatch updates of an update phase.

A learner's reference subclasses `PPOReference` with its networks
(`policy`, `values`), its extra loss terms and its optimizer groups.
"""
from __future__ import annotations

import json
import math
import pickle
from pathlib import Path

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def log_prob(mean, std, actions):
    return (-0.5 * (actions - mean) ** 2 / std ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi)).sum(-1)


def entropy(std):
    return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)).sum(-1)


def dense_leaves(tree: dict) -> list:
    """[kernel_0, bias_0, kernel_1, ...] of a flax module's `Dense_i` layers."""
    n = len([k for k in tree if k.startswith("Dense_")])
    out = []
    for i in range(n):
        out += [tree[f"Dense_{i}"]["kernel"], tree[f"Dense_{i}"]["bias"]]
    return out


class PPOReference:
    """The run that `config` names, on `device`, with products in
    `precision`. Subclasses set `self.start` (the checkpoint's leaves, in
    the order the program's optimizers hold them) and `self.groups`
    ([(loss name, leaf indices)], one per optimizer)."""

    ADAM_B1 = ADAM_B1

    def __init__(self, config: dict, root: Path, device, precision: str = "float32"):
        self.device, self.precision = torch.device(device), precision
        with open(Path(root) / config["snapshot"]) as f:
            self.snapshot = json.load(f)
        with open(Path(root) / config["checkpoint"], "rb") as f:
            self.payload = pickle.load(f)
        self.lr0 = float(self.payload["lr"])
        self.iteration = int(self.payload.get("iteration", 0))
        a = self.snapshot["algo"]["config"]
        self.gamma, self.lam, self.clip = float(a["gamma"]), float(a["lam"]), float(a["clip_param"])
        self.entropy_coef, self.value_loss_coef = float(a["entropy_coef"]), float(a["value_loss_coef"])
        self.desired_kl, self.max_grad_norm = float(a["desired_kl"]), float(a["max_grad_norm"])
        self.num_minibatches = int(a["num_mini_batches"])
        if not a["use_clipped_value_loss"] or a["l2c2"]["enable"]:
            raise NotImplementedError("the reference follows the clipped value loss without L2C2")
        self.action_clip = float(self.snapshot["robot"]["control"]["action_clip_value"])
        self.clip_obs = float((self.snapshot.get("normalization") or {}).get("clip_observations", 100.0))

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------- observation
    def action_slice(self) -> slice:
        """Where the last action sits in the actor's observation: groups are
        the sorted keys of `obs_dict`, a history key as wide as its steps."""
        o = self.snapshot["obs"]
        off = 0
        for name in sorted(o["obs_dict"]["actor_obs"]):
            hist = o.get("obs_auxiliary", {}).get(name)
            width = sum(o["obs_dims"][k] * n for k, n in hist.items()) if hist else o["obs_dims"][name]
            if name == "actions":
                return slice(off, off + width)
            off += width
        raise KeyError("the actor does not observe its last action")

    def observed_actions(self, actions):
        """The last action as the next observation holds it: clipped to the
        action limit, then to the observation limit (its scale is 1)."""
        if float(self.snapshot["obs"]["obs_scales"]["actions"]) != 1.0:
            raise NotImplementedError("the reference reads actions observed at scale 1")
        a = torch.clamp(actions, -self.action_clip, self.action_clip)
        return torch.clamp(a, -self.clip_obs, self.clip_obs)

    # -------------------------------------------------------------- learner
    def total_loss(self, terms: dict) -> float:
        """The minibatch loss from its terms."""
        return sum(w * float(terms[k]) for k, w in self.loss_weights().items())

    def loss_scale(self, terms: dict) -> float:
        """The size of the loss's terms, against which a gap in the loss is
        read (the terms can cancel)."""
        return sum(abs(w * float(terms[k])) for k, w in self.loss_weights().items())

    def loss_weights(self) -> dict:
        return {"surrogate": 1.0, "entropy": -self.entropy_coef, "value_loss": self.value_loss_coef}

    def gae(self, values, rewards, dones, last_values):
        advs = torch.empty_like(values)
        adv, v_next = torch.zeros_like(last_values), last_values
        for t in reversed(range(values.shape[0])):
            not_term = 1.0 - dones[t][:, None].to(torch.float32)
            delta = rewards[t] + not_term * self.gamma * v_next - values[t]
            adv = delta + not_term * self.gamma * self.lam * adv
            advs[t] = adv
            v_next = values[t]
        returns = advs + values
        tot = (returns - values).sum(-1)
        return returns, (tot - tot.mean()) / (tot.std(correction=0) + 1e-8)

    def adam(self, params, grads, state, lr):
        """optax `chain(clip_by_global_norm, adam)`: returns the clipped grads."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        state["count"] += 1
        c = np.float32(state["count"])
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** c)
        clipped = []
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
                g = torch.where(keep, g, g / g_norm * self.max_grad_norm)
                clipped.append(g)
                m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
                v.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v)
                p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))
        return clipped

    def ppo_terms(self, mean, std, values, mb: dict) -> dict:
        """The clipped surrogate, entropy, clipped value loss and KL of a
        minibatch (`mb`: actions, logp, mean, std, values, returns, adv of
        its rows)."""
        ratio = torch.exp(log_prob(mean, std, mb["actions"]) - mb["logp"])
        a = mb["adv"]
        surrogate = torch.maximum(-a * ratio, -a * torch.clamp(ratio, 1 - self.clip, 1 + self.clip)).mean()
        tv, ret = mb["values"], mb["returns"]
        v_clip = tv + torch.clamp(values - tv, -self.clip, self.clip)
        vloss = torch.maximum((values - ret) ** 2, (v_clip - ret) ** 2).sum(-1).mean()
        with torch.no_grad():
            kl = torch.sum(torch.log(std / mb["std"] + 1e-5)
                           + (mb["std"] ** 2 + (mb["mean"] - mean) ** 2) / (2.0 * std ** 2) - 0.5, dim=-1).mean()
        return {"surrogate": surrogate, "entropy": entropy(std).mean(), "value_loss": vloss, "kl": kl}

    def follow(self, rollout: dict, perm, steps: int) -> dict:
        """The first `steps` minibatch updates of the update phase on
        `rollout` (tensors on the device: the observation groups, actions
        [T,N,A], dones, time_outs [T,N], rew_raw [T,N,R], last_obs {group:
        [N,*]}), the first epoch visiting the flat samples in the order
        `perm`. Returns each step's loss terms, the first step's clipped
        gradients, the parameters before and after, and the rollout's
        networks' outputs worked out again."""
        if steps > self.num_minibatches:
            raise ValueError("the reference follows the first epoch only")
        T, N = rollout["actions"].shape[:2]
        obs = {k: rollout[k].reshape(T * N, *rollout[k].shape[2:]) for k in self.obs_groups}
        actions = rollout["actions"].reshape(T * N, -1)
        with torch.no_grad():
            mean_old, std_old = self.policy(obs, self.start, rollout=True)
            values_old = self.values(obs, self.start)
            values = values_old.reshape(T, N, -1)
            rewards = rollout["rew_raw"] + self.gamma * values * rollout["time_outs"][..., None].to(torch.float32)
            returns, adv = self.gae(values, rewards, rollout["dones"], self.values(rollout["last_obs"], self.start))
        flat = {"actions": actions, "logp": log_prob(mean_old, std_old, actions), "mean": mean_old,
                "std": std_old, "values": values_old, "returns": returns.reshape(T * N, -1),
                "adv": adv.reshape(T * N)}
        params = [p.clone().requires_grad_(True) for p in self.start]
        states = [{"count": 0, "mu": [torch.zeros_like(params[i]) for i in idx],
                   "nu": [torch.zeros_like(params[i]) for i in idx]} for _, idx in self.groups]
        lr = torch.tensor(self.lr0, dtype=torch.float32, device=self.device)
        mb = T * N // self.num_minibatches
        losses, first_grads = [], None
        for k in range(steps):
            idx = perm[k * mb:(k + 1) * mb]
            rows = {key: v[idx] for key, v in flat.items()}
            terms, named = self.minibatch(params, {g: v[idx] for g, v in obs.items()}, rows)
            lr = torch.where(terms["kl"] > self.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5),
                             torch.where((terms["kl"] < self.desired_kl / 2.0) & (terms["kl"] > 0.0),
                                         torch.clamp(lr * 1.5, max=1e-2), lr))
            clipped = [None] * len(params)
            for (name, pidx), state in zip(self.groups, states):
                ps = [params[i] for i in pidx]
                gs = torch.autograd.grad(named[name], ps, allow_unused=True, retain_graph=True)
                gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, ps)]
                for i, g in zip(pidx, self.adam(ps, gs, state, lr)):
                    clipped[i] = g
            if k == 0:
                first_grads = clipped
            losses.append({key: v.detach() for key, v in terms.items()})
        return {"losses": losses, "first_grads": first_grads, "start": self.start,
                "params": [p.detach() for p in params], "forward": {"mean": mean_old, "values": values_old}}
