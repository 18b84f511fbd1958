"""Multi-head PPO in torch (counterpart of `pbhc_tpu/agents/mh_ppo.py`).

One `train_iteration` is a rollout of `num_steps_per_env` env steps under the
stochastic actor, per-head GAE, and `num_learning_epochs` x `num_mini_batches`
updates, all on the env's device. The semantics are the JAX module's
(`mh_ppo.py:1-16`): one critic head per reward term, timeout bootstrapping per
head, advantages summed over heads then normalised (population std), the
clipped surrogate and clipped value loss, the adaptive-KL learning rate, a
global-norm clip then Adam per network, and L2C2 behind its config flag.

Two things follow the JAX code rather than its comments or PyTorch's
defaults: the KL of a minibatch sets the lr of that same minibatch's Adam step
(`mh_ppo.py:213-224`), and the clip is optax's `clip_by_global_norm` (scale by
max_norm / |g| only when |g| exceeds max_norm, no epsilon), written out here
with optax's Adam (eps 1e-8 outside the square root), with the lr a device
tensor so that no step waits on the host.

Randomness comes from `torch.Generator`s on the env's device: actions and
L2C2 interpolation from a per-rank one, the minibatch permutations from one
seeded alike on every rank (one generator for both in a single process);
fresh network weights from a CPU generator seeded with the run's seed, so
that a run gets the same initial weights on every device.

Under env-axis data parallelism (`parallel/mesh.py`) each rank holds its
envs' rows of the rollout: a minibatch is the rows of the global
permutation's slice that fall in them, every loss is the rank's share of the
global minibatch mean, and the gradients, the KL and the logged losses are
summed over ranks (one all-reduce per minibatch) before the clip and Adam.

On a card each minibatch step (`_minibatch_update`) replays a CUDA graph
where `learner_eligible` allows (`_minibatch`, through
`sim/step_graph.py::StageGraphs`): the forward, `torch.autograd.grad`, the
losses, the KL-adaptive lr, the clip and Adam on every parameter, the same
kernels in the same order, issued with one launch. The step's arguments are
the lr and the minibatch; the lr it makes comes back out and is rebound on
the train state. It holds the networks' parameters and buffers and the
optimizers' lists by identity (`_learner_fixed`: an emptied or replaced list
captures the step anew) and writes parameters and moments in place, never
an argument. What a step takes from the host (Adam's step counts and bias
corrections) is written into device scalars before each replay
(`_host_values`), never while a step is captured (`capturing`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from pbhc_tpu_torch.agents.networks import (actor_from_config, critic_from_config, flax_init_,
                                            gaussian_entropy, gaussian_log_prob, phase_embed_config,
                                            phase_position)
from pbhc_tpu_torch.sim.step_graph import StageGraphs
from pbhc_tpu_torch.utils.profiling import span

# the learner methods of one minibatch step: one shadowed on the learner
# instance (a recorder, a planted fault) keeps every minibatch step eager
LEARNER_STEPS = ("_minibatch_update", "update_rl", "update_distill")


def capturing(t: torch.Tensor) -> bool:
    """Whether the current stream of `t`'s device is being captured into a
    CUDA graph: a host value written into `t` now would be baked into the
    graph, so the learner writes it before each replay instead."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class Adam:
    """`optax.chain(clip_by_global_norm(max_norm), adam(lr))` over one
    network's parameters (`mh_ppo.py:99-102`), with the lr given per step.

    The step's bias corrections are device scalars (`corrections`) that
    `advance` writes from the host, so that a step captured as a CUDA graph
    (`MHPPO._minibatch`) reads each replay's own."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, max_grad_norm: float):
        self.params = list(params)
        self.max_grad_norm = float(max_grad_norm)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        device = self.params[0].device if self.params else None
        self.corrections = [torch.ones((), device=device) for _ in range(2)]

    def advance(self):
        """Count one step and write its bias corrections, as optax forms them
        (decay ** count in float32), into `corrections`: two fills, no sync.
        On a CUDA device each is written as its float32 reciprocal and the
        step multiplies by it, as PyTorch's CUDA kernels divide by a Python
        float; elsewhere the step divides by it. Either way the step equals
        the one that divided by Python floats, bit for bit."""
        self.count += 1
        for t, b in zip(self.corrections, (self.b1, self.b2)):
            c = np.float32(1.0) - np.float32(b) ** np.float32(self.count)
            t.fill_(float(np.float32(1.0) / c) if t.is_cuda else float(c))

    @torch.no_grad()
    def step(self, grads, lr):
        """One clipped Adam step, counted by `advance` first; a step being
        captured into a CUDA graph is not counted: its replays are
        (`capturing`)."""
        if not capturing(self.corrections[0]):
            self.advance()
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        c1, c2 = self.corrections
        scale = torch.mul if c1.is_cuda else torch.div
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, g / g_norm * self.max_grad_norm)
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            p.add_(-lr * (scale(m, c1) / (torch.sqrt(scale(v, c2)) + self.eps)))

    def state_dict(self) -> dict:
        """Step count and moments as numpy arrays, in parameter order."""
        return {"count": self.count, "mu": [m.cpu().numpy().copy() for m in self.mu],
                "nu": [v.cpu().numpy().copy() for v in self.nu]}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if len(state["mu"]) != len(self.mu) or any(
                tuple(a.shape) != tuple(m.shape) for a, m in zip(state["mu"], self.mu)):
            raise ValueError("optimizer state does not fit the network's parameters")
        self.count = int(state["count"])
        for dst, a in (*zip(self.mu, state["mu"]), *zip(self.nu, state["nu"])):
            dst.copy_(torch.as_tensor(a))


def train_state_parts(ts) -> tuple:
    """The networks and the optimizers among the fields of the train state
    `ts` (`TrainState`, PPOMimic's `MimicTrainState`), in field order."""
    parts = [getattr(ts, f.name) for f in dataclasses.fields(ts)]
    return [v for v in parts if isinstance(v, torch.nn.Module)], [v for v in parts if isinstance(v, Adam)]


def learner_eligible(learner, optimizers) -> bool:
    """Whether `learner`'s next minibatch step may replay: on a CUDA device,
    in one process (a data-parallel step all-reduces its gradients
    eagerly), with none of `LEARNER_STEPS` shadowed on the learner instance
    and no `step` shadowed on one of the train state's `optimizers`. A step
    whose first call ran a sync stays eager by `StageGraphs`' own check."""
    return (torch.device(learner.device).type == "cuda" and not learner.shard.distributed
            and not any(name in vars(learner) for name in LEARNER_STEPS)
            and not any("step" in vars(o) for o in optimizers))


def _learner_fixed(learner, nets, optimizers) -> tuple:
    """What a minibatch step reads as fixed, held by identity: the learner's
    own tensors, the networks' parameters and buffers, and the
    `optimizers`' parameters, moments and bias corrections."""
    held = [v for v in vars(learner).values() if isinstance(v, torch.Tensor)]
    for net in nets:
        held.extend((*net.parameters(), *net.buffers()))
    for o in optimizers:
        held.extend((*o.params, *o.mu, *o.nu, *o.corrections))
    return tuple(held)


@dataclasses.dataclass
class TrainState:
    """What one iteration carries to the next (`mh_ppo.py:32`). The networks
    and optimizers are updated in place."""

    actor: torch.nn.Module
    critic: torch.nn.Module
    actor_opt: Adam
    critic_opt: Adam
    lr: torch.Tensor                   # 0-d adaptive lr, shared by actor and critic
    env_state: object
    obs: Dict[str, torch.Tensor]
    iteration: int


class MHPPO:
    def __init__(self, config, env, seed: int = 0):
        self.config = config.algo.config
        self.full_config = config
        self.env = env
        self.device = env.device
        self.seed = int(seed)
        self.shard = env.shard
        # the env's generators have `seed`; `perm_gen` is seeded alike on every rank
        self.gen, self.perm_gen = self.shard.generators(self.seed + 1, self.device)
        c = self.config
        self.gamma = float(c.gamma)
        self.lam = float(c.lam)
        self.clip = float(c.clip_param)
        self.entropy_coef = float(c.entropy_coef)
        self.value_loss_coef = float(c.value_loss_coef)
        self.desired_kl = float(c.desired_kl)
        self.max_grad_norm = float(c.max_grad_norm)
        self.num_steps = int(c.num_steps_per_env)
        self.num_epochs = int(c.num_learning_epochs)
        self.num_minibatches = int(c.num_mini_batches)
        self.use_clipped_value_loss = bool(c.use_clipped_value_loss)
        self.l2c2 = bool(c.l2c2.enable)
        self.num_act = int(env.num_actions)
        self.num_rew = int(env.num_rew_fn)
        self.storage_dtype = torch.bfloat16 if str(c.get("storage_dtype", "float32")) == "bfloat16" \
            else torch.float32
        self.actor_dim = env.obs_dim("actor_obs")
        self.critic_dim = env.obs_dim("critic_obs")
        # phase-aware networks read the phase at its place in each obs group (`mh_ppo.py:67-87`)
        phase_aware = phase_embed_config(config)[0] != "Original"
        self.phase_pos = {g: phase_position(env, g) if phase_aware else None for g in ("actor_obs", "critic_obs")}
        # the minibatch steps, replayed as CUDA graphs where the rules allow
        self.graphs = StageGraphs(LEARNER_STEPS)

    # ------------------------------------------------------------------ setup
    def new_train_state(self, actor, critic, env_state=None, obs=None) -> TrainState:
        """A state around given networks, with fresh optimizers and the
        configured initial lr."""
        return TrainState(
            actor=actor, critic=critic,
            actor_opt=Adam(actor.parameters(), self.max_grad_norm),
            critic_opt=Adam(critic.parameters(), self.max_grad_norm),
            lr=torch.tensor(float(self.config.actor_learning_rate), device=self.device),
            env_state=env_state, obs=obs, iteration=0)

    def init_train_state(self) -> TrainState:
        """Fresh networks (flax's initialisers), env state and first obs (`mh_ppo.py:106`)."""
        init_gen = torch.Generator().manual_seed(self.seed)
        actor = flax_init_(actor_from_config(self.full_config, self.actor_dim, self.num_act,
                                             self.phase_pos["actor_obs"]), init_gen)
        critic = flax_init_(critic_from_config(self.full_config, self.critic_dim, self.num_rew,
                                               self.phase_pos["critic_obs"]), init_gen)
        env_state = self.env.init_state()
        obs, env_state.history = self.env.compute_observations(env_state)
        return self.new_train_state(actor.to(self.device), critic.to(self.device), env_state, obs)

    # ---------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout(self, ts: TrainState):
        """The rollout phase, `num_steps` env steps (`mh_ppo.py:127`). Returns
        (env_state, obs, trajectory {key: [T,N,...]}, env logs {key: [T]})."""
        with span("learner.rollout"):
            env_state, obs = ts.env_state, ts.obs
            traj, logs = {}, {}
            sd = self.storage_dtype
            for t in range(self.num_steps):
                with span("policy"):
                    mean, std = ts.actor(obs["actor_obs"])
                    actions = mean + std * torch.randn(mean.shape, generator=self.gen, device=self.device)
                    logp = gaussian_log_prob(mean, std, actions)
                    values = ts.critic(obs["critic_obs"])
                env_state, next_obs, rew, done, info = self.env.step(env_state, actions)
                # timeout bootstrapping per head (reference ppo.py:267-268)
                rew_stored = rew + self.gamma * values * info["time_outs"][:, None]
                data = dict(actor_obs=obs["actor_obs"].to(sd), critic_obs=obs["critic_obs"].to(sd),
                            actions=actions, logp=logp, mean=mean, std=std, values=values,
                            rewards=rew_stored, dones=done)
                if self.l2c2:
                    data["next_actor_obs"] = next_obs["actor_obs"].to(sd)
                    data["next_critic_obs"] = next_obs["critic_obs"].to(sd)
                for k, v in data.items():
                    if k not in traj:
                        traj[k] = torch.empty((self.num_steps, *v.shape), dtype=v.dtype, device=v.device)
                    traj[k][t] = v
                for k, v in info["log"].items():
                    logs.setdefault(k, []).append(v)
                obs = next_obs
            return env_state, obs, traj, self.env.global_logs({k: torch.stack(v) for k, v in logs.items()})

    def _gae(self, traj, last_values):
        """Per-head GAE; advantages summed over heads, then normalised with the
        population std over every rank's samples (`mh_ppo.py:148`)."""
        with span("learner.gae"):
            values, rewards, dones = traj["values"], traj["rewards"], traj["dones"]
            advs = torch.empty_like(values)
            adv, v_next = torch.zeros_like(last_values), last_values
            for t in reversed(range(values.shape[0])):
                not_term = 1.0 - dones[t][:, None].to(torch.float32)
                delta = rewards[t] + not_term * self.gamma * v_next - values[t]
                adv = delta + not_term * self.gamma * self.lam * adv
                advs[t] = adv
                v_next = values[t]
            returns = advs + values                                    # [T,N,R]
            tot_adv = (returns - values).sum(-1)                       # [T,N]
            mean, std = self.shard.mean_std(tot_adv)
            adv_norm = (tot_adv - mean) / (std + 1e-8)
            return returns, adv_norm

    # ----------------------------------------------------------------- update
    def _l2c2_obs(self, obs, next_obs):
        u = torch.rand(obs.shape[:-1] + (1,), generator=self.gen, device=obs.device) * 2 - 1
        return obs + u * (next_obs.to(torch.float32) - obs)

    def _host_values(self, ts: TrainState, name: str):
        """What the minibatch step `name` takes from the host, written to the
        device before a replay of it: both optimizers' counts and bias
        corrections."""
        ts.actor_opt.advance()
        ts.critic_opt.advance()

    def _minibatch_update(self, ts: TrainState, batch, rows: int | None = None) -> dict:
        """One Adam step of actor and critic on `batch` (`mh_ppo.py:167`), this
        rank's rows of a minibatch of `rows` rows in all (default: `batch`'s).
        Updates `ts` in place; returns the minibatch's metrics."""
        avg = functools.partial(self.shard.share, rows=len(batch["actions"]) if rows is None else rows)
        aobs = batch["actor_obs"].to(torch.float32)
        mean, std = ts.actor(aobs)
        logp = gaussian_log_prob(mean, std, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        surr = -adv * ratio
        surr_clipped = -adv * torch.clamp(ratio, 1 - self.clip, 1 + self.clip)
        surrogate = avg(torch.maximum(surr, surr_clipped))
        entropy = avg(gaussian_entropy(std))
        a_loss = surrogate - self.entropy_coef * entropy
        if self.l2c2:
            u_mean, _ = ts.actor(self._l2c2_obs(aobs, batch["next_actor_obs"]))
            a_loss = a_loss + float(self.config.l2c2.lambda_policy) * avg((batch["actions"] - u_mean) ** 2)
        with torch.no_grad():
            # KL for the adaptive lr (reference mh_ppo.py:469-483)
            kl = avg(torch.sum(torch.log(std / batch["std"] + 1e-5)
                               + (batch["std"] ** 2 + (batch["mean"] - mean) ** 2) / (2.0 * std ** 2) - 0.5,
                               dim=-1))

        cobs = batch["critic_obs"].to(torch.float32)
        value = ts.critic(cobs)
        target_v, returns = batch["values"], batch["returns"]
        if self.use_clipped_value_loss:
            v_clipped = target_v + torch.clamp(value - target_v, -self.clip, self.clip)
            vloss = avg(torch.maximum((value - returns) ** 2, (v_clipped - returns) ** 2).sum(-1))
        else:
            vloss = avg(((returns - value) ** 2).sum(-1))
        c_loss = self.value_loss_coef * vloss
        if self.l2c2:
            u_val = ts.critic(self._l2c2_obs(cobs, batch["next_critic_obs"]))
            c_loss = c_loss + float(self.config.l2c2.lambda_value) * avg((value - u_val) ** 2)

        a_grads = torch.autograd.grad(a_loss, ts.actor_opt.params)
        c_grads = torch.autograd.grad(c_loss, ts.critic_opt.params)
        # the ranks' shares summed: global gradients, KL and losses (one all-reduce)
        na = len(a_grads)
        *grads, kl, surrogate, vloss, entropy = self.shard.all_sum(
            [*a_grads, *c_grads, kl, surrogate.detach(), vloss.detach(), entropy.detach()], dtype=torch.float32)
        a_grads, c_grads = grads[:na], grads[na:]
        # the adaptive lr of this step, from this minibatch's KL (`mh_ppo.py:213-219`)
        lr = ts.lr
        lr = torch.where(kl > self.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5),
                         torch.where((kl < self.desired_kl / 2.0) & (kl > 0.0),
                                     torch.clamp(lr * 1.5, max=1e-2), lr))
        ts.lr = lr
        ts.actor_opt.step(a_grads, lr)
        ts.critic_opt.step(c_grads, lr)
        return dict(surrogate=surrogate.detach(), value_loss=vloss.detach(), entropy=entropy.detach(),
                    kl=kl)

    def _minibatch(self, ts, name: str, batch, rows: int):
        """`self.<name>(ts, batch, rows)`, the minibatch step `name` (one of
        `LEARNER_STEPS`), in its `learner.minibatch` span. Where
        `learner_eligible` allows, the class's method runs on a copy of `ts`
        that takes the lr as an argument, captured at its first call and
        replayed after (`StageGraphs.run_step`, the replay in
        `learner.graph_replay`, `_host_values(ts, name)` written before
        it), and `ts.lr` is rebound to the lr it makes; else the method
        itself runs."""
        with span("learner.minibatch"):
            nets, opts = train_state_parts(ts)
            if not learner_eligible(self, opts):
                return self.graphs.run_step(name, getattr(self, name), (ts, batch, rows), False)
            method = getattr(type(self), name)

            def step(lr, batch, rows):
                view = dataclasses.replace(ts, lr=lr)
                return method(self, view, batch, rows), view.lr

            out, ts.lr = self.graphs.run_step(name, step, (ts.lr, batch, rows), True,
                                              lambda: _learner_fixed(self, nets, opts), lambda: (self.gen,),
                                              "learner.graph_replay", lambda: self._host_values(ts, name))
            return out

    def learn(self, ts: TrainState, rollout, perms=None):
        """The update phase (`mh_ppo.py:235-287`) on a `rollout` (this rank's
        envs): GAE, then for each epoch's permutation of the global flat
        samples (`perms`, drawn from `perm_gen` when None) `num_minibatches`
        minibatch updates (`_minibatch`). Updates `ts` in place and returns
        it with the iteration's log (0-d tensors, not synchronised)."""
        with span("learner.update"):
            env_state, obs, traj, env_logs = rollout
            with torch.no_grad():
                last_values = ts.critic(obs["critic_obs"])
            returns, advantages = self._gae(traj, last_values)
            T, N = traj["values"].shape[:2]
            flat = {k: v.reshape(T * N, *v.shape[2:]) for k, v in traj.items()}
            flat["returns"] = returns.reshape(T * N, -1)
            flat["advantages"] = advantages.reshape(T * N)
            samples = T * self.shard.num_envs             # over every rank
            if perms is None:
                perms = [torch.randperm(samples, generator=self.perm_gen, device=self.device)
                         for _ in range(self.num_epochs)]
            mb = samples // self.num_minibatches
            metrics = []
            for perm in perms:
                for i in range(self.num_minibatches):
                    idx = self.shard.local_rows(perm[i * mb:(i + 1) * mb])
                    metrics.append(self._minibatch(ts, "_minibatch_update", {k: v[idx] for k, v in flat.items()}, mb))
            mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
            log = {f"Env/{k}": v.mean() for k, v in env_logs.items()}
            log.update({
                "Train/mean_step_reward": self.shard.global_mean(traj["rewards"].sum(-1)),
                "Loss/surrogate": mean["surrogate"],
                "Loss/value": mean["value_loss"],
                "Loss/entropy": mean["entropy"],
                "Loss/kl": mean["kl"],
                "Loss/lr": ts.lr,
            })
            ts.env_state, ts.obs, ts.iteration = env_state, obs, ts.iteration + 1
            return ts, log

    def train_iteration(self, ts: TrainState):
        """Rollout + update (`mh_ppo.py:232`): `learn(ts, rollout(ts))`."""
        return self.learn(ts, self.rollout(ts))
