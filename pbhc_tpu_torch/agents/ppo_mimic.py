"""Teacher-student PPO (KungfuBot2) in torch (counterpart of
`pbhc_tpu/agents/ppo_mimic.py`).

Three modes on one `MimicActorCritic`, with the JAX module's semantics:
- RL: PPO through the priv-encoder latent, plus a `priv_reg` loss that pulls
  the priv latent toward the (stop-gradient) history latent with the staged
  coefficient schedule, the reference KL `log(sigma/sigma_old + 1e-5) + ...`
  and the adaptive lr set from a minibatch's KL before that minibatch's Adam
  step (`ppo_mimic.py:236-276`);
- every `dagger_update_freq`-th RL iteration rolls out through the history
  latent and runs a DAgger pass on the same data after the RL update: the
  history encoder regresses onto the frozen priv latent through its own Adam
  (`hist_opt`, fixed lr), and nothing else moves (`:278-345`);
- with a `MoEMLP` actor or critic backbone, the RL loss adds
  `load_balancing_loss_alpha` x the sum of the Switch load-balance losses of
  the backbones `act` and `evaluate` ran (`ppo_mimic.py:125-131`, `:227-263`),
  and the iteration logs their mean as `Loss/load_balancing` (the JAX module
  computes it and does not log it); like the JAX module, no other update adds
  it;
- distillation (`dagger_only` with a teacher): the student drives the env
  with its deterministic history-latent action and clones the frozen
  teacher's with an L2 loss; the history encoder grafted from the teacher
  stays frozen (`:367-405`).

Each mode is a `rollout` phase and a `learn` phase, as in `MHPPO`, so that
the training CLI times both. Adam is `mh_ppo.Adam` (optax's global-norm clip
and Adam written out). Randomness comes from `torch.Generator`s on the env's
device (actions from a per-rank one, minibatch permutations from one seeded
alike on every rank; one generator for both in a single process); fresh
weights from a CPU generator seeded with the run's seed.

Under env-axis data parallelism (`parallel/mesh.py`) each update takes the
rows of its global minibatch that this rank holds (the RL epochs' global
permutation, DAgger's and distillation's consecutive global slices), every
loss is the rank's share of the global minibatch mean, and the gradients and
logged losses are summed over ranks before the clip and Adam. The MoE
load-balance loss `E * sum_e f_e * P_e` multiplies two batch means: `f` (no
gradient) is all-reduced in the forward, `P` is the rank's share, so that
the ranks' losses sum to the global loss and gradient.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from pbhc_tpu_torch.agents.mh_ppo import MHPPO, Adam
from pbhc_tpu_torch.agents.mimic_networks import MimicActorCritic, mimic_net_from_config
from pbhc_tpu_torch.agents.networks import flax_init_, gaussian_entropy, gaussian_log_prob

OBS_KEYS = ("actor_obs", "priv_obs", "future_motion_targets", "prop_history")


def graft_history_encoder(net: MimicActorCritic, teacher: MimicActorCritic):
    """Copy the teacher's history encoder into `net` (`ppo_mimic.py:35`): the
    student's deployable latent starts from the teacher's DAgger-trained one."""
    src = teacher.actor.history_encoder.state_dict()
    dst = net.actor.history_encoder.state_dict()
    for k, v in src.items():
        if v.shape != dst[k].shape:
            raise ValueError(f"teacher/student history_encoder shape mismatch at {k}: "
                             f"{tuple(v.shape)} vs {tuple(dst[k].shape)}")
    net.actor.history_encoder.load_state_dict(src)
    return net


class Teacher:
    """A frozen teacher for distillation (`train.py:315-358`): its own net,
    fed the teacher-side obs groups the student env computes too, acting
    deterministically through its history latent."""

    def __init__(self, net: MimicActorCritic):
        self.net = net.eval()
        for p in self.net.parameters():
            p.requires_grad_(False)

    @torch.no_grad()
    def __call__(self, obs):
        tobs = {"actor_obs": obs["teacher_actor_obs"],
                "future_motion_targets": obs["teacher_future_motion_targets"],
                "priv_obs": obs["priv_obs"], "prop_history": obs["prop_history"]}
        return self.net.act(tobs, True)[0]


@dataclasses.dataclass
class MimicTrainState:
    """What one iteration carries to the next (`ppo_mimic.py:83`); the net
    and both optimizers are updated in place."""

    net: MimicActorCritic
    opt: Adam                          # all params, adaptive lr
    hist_opt: Adam                     # the history encoder, fixed lr
    lr: torch.Tensor                   # 0-d
    env_state: object
    obs: Dict[str, torch.Tensor]
    iteration: int


def _grads(loss, params):
    """d loss / d params, zeros for params the loss does not reach."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]


class PPOMimic:
    def __init__(self, config, env, teacher: Teacher | None = None, seed: int = 0):
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
        self.learning_rate = float(c.learning_rate)
        self.num_steps = int(c.num_steps_per_env)
        self.num_epochs = int(c.num_learning_epochs)
        self.num_minibatches = int(c.num_mini_batches)
        self.dagger_update_freq = int(c.get("dagger_update_freq", 20))
        self.dagger_only = bool(c.get("dagger_only", False))
        self.priv_reg_schedule = [float(x) for x in c.priv_reg_coef_schedual]
        self.num_act = int(env.num_actions)
        kinds = [str(c.module_dict[m].layer_config.get("type", "MLP")) for m in ("actor", "critic")]
        self.use_moe = "MoEMLP" in kinds
        self.lb_alpha = float(c.get("load_balancing_loss_alpha", 1e-2))
        self.teacher = teacher
        if self.dagger_only and teacher is None:
            raise ValueError("dagger_only (distillation) needs algo.config.teacher_model_path")
        obs = config.obs
        self.future_steps, self.history_steps = int(obs.future_num_steps), int(obs.history_length)
        if env.obs_dim("future_motion_targets") % self.future_steps or \
                env.obs_dim("prop_history") % self.history_steps:
            raise ValueError("future/history widths are not whole steps")

    # ------------------------------------------------------------------ setup
    def new_train_state(self, net, env_state=None, obs=None) -> MimicTrainState:
        """A state around `net`, with fresh optimizers and the configured lr."""
        return MimicTrainState(
            net=net, opt=Adam(net.parameters(), self.max_grad_norm),
            hist_opt=Adam(net.actor.history_encoder.parameters(), self.max_grad_norm),
            lr=torch.tensor(self.learning_rate, device=self.device),
            env_state=env_state, obs=obs, iteration=0)

    def init_train_state(self) -> MimicTrainState:
        """Fresh net (flax's initialisers), env state and first obs
        (`ppo_mimic.py:152`); in distillation the teacher's history encoder
        is grafted in."""
        net = flax_init_(mimic_net_from_config(self.full_config, self.num_act),
                         torch.Generator().manual_seed(self.seed))
        if self.teacher is not None and self.dagger_only:
            graft_history_encoder(net, self.teacher.net)
        env_state = self.env.init_state()
        obs, env_state.history = self.env.compute_observations(env_state)
        return self.new_train_state(net.to(self.device), env_state, obs)

    # ------------------------------------------------------------------- mode
    def mode(self, ts: MimicTrainState) -> str:
        """`train_iteration`'s dispatch (`ppo_mimic.py:407`): "distill", or
        "rl+dagger" every `dagger_update_freq`-th iteration, else "rl"."""
        if self.dagger_only:
            return "distill"
        f = self.dagger_update_freq
        return "rl+dagger" if f > 0 and ts.iteration % f == 0 else "rl"

    # ---------------------------------------------------------------- rollout
    @torch.no_grad()
    def rollout(self, ts: MimicTrainState, hist_encoding: bool | None = None):
        """`num_steps` env steps (`ppo_mimic.py:176`) through the history
        latent when `hist_encoding` (default: as `mode` says). Actions are the
        mean in distillation, else mean + std x normal. Returns (env_state,
        obs, trajectory {key: [T,N,...]}, env logs {key: [T]}, hist_encoding)."""
        if hist_encoding is None:
            hist_encoding = self.mode(ts) != "rl"
        env_state, obs = ts.env_state, ts.obs
        traj, logs = {}, {}
        for t in range(self.num_steps):
            mean, std = ts.net.act(obs, hist_encoding)
            actions = mean if self.dagger_only else \
                mean + std * torch.randn(mean.shape, generator=self.gen, device=self.device)
            values = ts.net.evaluate(obs)
            data = {k: obs[k] for k in OBS_KEYS}
            data.update(actions=actions, logp=gaussian_log_prob(mean, std, actions), mean=mean, std=std,
                        values=values)
            if self.teacher is not None:
                data["teacher_actions"] = self.teacher(obs)
            env_state, obs, rew, done, info = self.env.step(env_state, actions)
            data.update(rewards=rew + self.gamma * values * info["time_outs"][:, None], dones=done)
            for k, v in data.items():
                if k not in traj:
                    traj[k] = torch.empty((self.num_steps, *v.shape), dtype=v.dtype, device=v.device)
                traj[k][t] = v
            for k, v in info["log"].items():
                logs.setdefault(k, []).append(v)
        return env_state, obs, traj, self.env.global_logs({k: torch.stack(v) for k, v in logs.items()}), hist_encoding

    # GAE with advantages summed over heads and normalised with the population
    # std: the same computation as MHPPO's (`ppo_mimic.py:204`, `mh_ppo.py:148`)
    _gae = MHPPO._gae

    # ----------------------------------------------------------------- updates
    def priv_reg_coef(self, iteration: int) -> float:
        """`ppo_mimic.py:222`, in float32 as there."""
        s = np.asarray(self.priv_reg_schedule, dtype=np.float32)
        stage = np.clip((np.float32(iteration) - s[2]) / s[3], np.float32(0), np.float32(1))
        return float(stage * (s[1] - s[0]) + s[0])

    def update_rl(self, ts: MimicTrainState, batch, rows: int | None = None) -> dict:
        """One RL minibatch (`ppo_mimic.py:236`), this rank's rows of a
        minibatch of `rows` rows in all (default: `batch`'s); updates `ts` in
        place."""
        rows = len(batch["actions"]) if rows is None else rows
        avg = functools.partial(self.shard.share, rows=rows)
        net = ts.net
        obs = {k: batch[k] for k in OBS_KEYS}
        (mean, std), lb_a = net.act_lb(obs, False, dp=(self.shard, rows))
        ratio = torch.exp(gaussian_log_prob(mean, std, batch["actions"]) - batch["logp"])
        adv = batch["advantages"]
        surr = avg(torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1 - self.clip, 1 + self.clip)))
        entropy = avg(gaussian_entropy(std))
        value, lb_v = net.evaluate_lb(obs, dp=(self.shard, rows))
        tv, ret = batch["values"], batch["returns"]
        v_clip = tv + torch.clamp(value - tv, -self.clip, self.clip)
        vloss = avg(torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).sum(-1))
        priv_lat = net.priv_latent(batch["priv_obs"])
        with torch.no_grad():
            hist_lat = net.hist_latent(batch["prop_history"])
        priv_reg = avg(torch.linalg.vector_norm(priv_lat - hist_lat, dim=-1))
        lb = lb_a + lb_v
        loss = (surr - self.entropy_coef * entropy + self.value_loss_coef * vloss
                + self.priv_reg_coef(ts.iteration) * priv_reg + self.lb_alpha * lb)
        with torch.no_grad():
            kl = avg(torch.sum(torch.log(std / batch["std"] + 1e-5)
                               + (batch["std"] ** 2 + (batch["mean"] - mean) ** 2) / (2.0 * std ** 2) - 0.5,
                               dim=-1))
        # the ranks' shares summed: global gradients, KL and losses (one all-reduce)
        *grads, kl, surr, vloss, entropy, priv_reg, lb = self.shard.all_sum(
            [*_grads(loss, ts.opt.params), kl, *(x.detach() for x in (surr, vloss, entropy, priv_reg, lb))],
            dtype=torch.float32)
        lr = ts.lr
        ts.lr = torch.where(kl > self.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5),
                            torch.where((kl < self.desired_kl / 2.0) & (kl > 0.0),
                                        torch.clamp(lr * 1.5, max=1e-2), lr))
        ts.opt.step(grads, ts.lr)
        return dict(surrogate=surr, value_loss=vloss, entropy=entropy, kl=kl, priv_reg=priv_reg,
                    load_balancing=lb)

    def update_dagger(self, ts: MimicTrainState, priv_obs, prop_history, rows: int | None = None):
        """One history-encoder minibatch (`ppo_mimic.py:326`): the history
        latent regresses onto the frozen priv latent; only `hist_opt`'s
        params (the history encoder) move. `rows` as in `update_rl`."""
        rows = len(priv_obs) if rows is None else rows
        with torch.no_grad():
            target = ts.net.priv_latent(priv_obs)
        loss = self.shard.share(torch.linalg.vector_norm(ts.net.hist_latent(prop_history) - target, dim=-1), rows)
        *grads, loss = self.shard.all_sum([*_grads(loss, ts.hist_opt.params), loss.detach()], dtype=torch.float32)
        ts.hist_opt.step(grads, self.learning_rate)
        return loss

    def update_distill(self, ts: MimicTrainState, batch, rows: int | None = None):
        """One behaviour-cloning minibatch (`ppo_mimic.py:382-396`): L2 to the
        teacher's action; the history encoder's grads are zeroed, so it
        stays as grafted. `rows` as in `update_rl`."""
        rows = len(batch["teacher_actions"]) if rows is None else rows
        student = ts.net.act({k: batch[k] for k in OBS_KEYS}, True)[0]
        loss = self.shard.share(torch.linalg.vector_norm(batch["teacher_actions"] - student, dim=-1), rows)
        *grads, loss = self.shard.all_sum([*_grads(loss, ts.opt.params), loss.detach()], dtype=torch.float32)
        frozen = {id(p) for p in ts.hist_opt.params}
        grads = [torch.zeros_like(p) if id(p) in frozen else g for p, g in zip(ts.opt.params, grads)]
        ts.opt.step(grads, ts.lr)
        return loss

    # ------------------------------------------------------------------ learn
    def _global_slices(self, T):
        """The local rows of the `num_minibatches` consecutive slices of the
        global flat samples, and the slices' size."""
        samples = T * self.shard.num_envs
        mb = samples // self.num_minibatches
        return [self.shard.local_rows(torch.arange(i * mb, (i + 1) * mb, device=self.device))
                for i in range(self.num_minibatches)], mb

    def _dagger_pass(self, ts, flat, T):
        """`num_minibatches` consecutive DAgger minibatches (`ppo_mimic.py:315-321`)."""
        slices, mb = self._global_slices(T)
        return torch.stack([self.update_dagger(ts, flat["priv_obs"][idx], flat["prop_history"][idx], mb)
                            for idx in slices]).mean()

    def learn(self, ts: MimicTrainState, rollout, perms=None):
        """The update phase of the iteration `rollout` came from: RL (with the
        DAgger pass when the rollout went through the history latent) or
        distillation. `perms`: the RL epochs' permutations (drawn when None).
        Updates `ts` in place; returns it with the log (0-d tensors)."""
        env_state, obs, traj, env_logs, hist_encoding = rollout
        T, N = traj["values"].shape[:2]
        log = {f"Env/{k}": v.mean() for k, v in env_logs.items()}
        log["Train/mean_step_reward"] = self.shard.global_mean(traj["rewards"].sum(-1))
        if self.dagger_only:
            keys = (*OBS_KEYS, "teacher_actions")
            flat = {k: traj[k].reshape(T * N, *traj[k].shape[2:]) for k in keys}
            slices, mb = self._global_slices(T)
            losses = [self.update_distill(ts, {k: v[idx] for k, v in flat.items()}, mb) for idx in slices]
            log.update({"Loss/bc": torch.stack(losses).mean(),
                        "Loss/kl": torch.zeros((), device=self.device), "Loss/lr": ts.lr})
        else:
            with torch.no_grad():
                last_values = ts.net.evaluate(obs)
            returns, advantages = self._gae(traj, last_values)
            flat = {k: v.reshape(T * N, *v.shape[2:]) for k, v in traj.items()}
            flat["returns"] = returns.reshape(T * N, -1)
            flat["advantages"] = advantages.reshape(T * N)
            samples = T * self.shard.num_envs                 # over every rank
            if perms is None:
                perms = [torch.randperm(samples, generator=self.perm_gen, device=self.device)
                         for _ in range(self.num_epochs)]
            mb = samples // self.num_minibatches
            metrics = [self.update_rl(ts, {k: v[self.shard.local_rows(perm[i * mb:(i + 1) * mb])]
                                           for k, v in flat.items()}, mb)
                       for perm in perms for i in range(self.num_minibatches)]
            mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
            log.update({"Loss/surrogate": mean["surrogate"], "Loss/value": mean["value_loss"],
                        "Loss/kl": mean["kl"], "Loss/priv_reg": mean["priv_reg"], "Loss/lr": ts.lr})
            if self.use_moe:
                log["Loss/load_balancing"] = mean["load_balancing"]
            if hist_encoding:
                log["Loss/hist_latent"] = self._dagger_pass(ts, flat, T)
        ts.env_state, ts.obs, ts.iteration = env_state, obs, ts.iteration + 1
        return ts, log

    def dagger_iteration(self, ts: MimicTrainState):
        """A DAgger-only iteration (`ppo_mimic.py:347`): a history-latent
        rollout and one DAgger pass over it, no RL update."""
        env_state, obs, traj, env_logs, _ = self.rollout(ts, hist_encoding=True)
        T, N = traj["values"].shape[:2]
        flat = {k: traj[k].reshape(T * N, -1) for k in ("priv_obs", "prop_history")}
        log = {f"Env/{k}": v.mean() for k, v in env_logs.items()}
        log.update({"Loss/hist_latent": self._dagger_pass(ts, flat, T),
                    "Train/mean_step_reward": self.shard.global_mean(traj["rewards"].sum(-1)),
                    "Loss/kl": torch.zeros((), device=self.device), "Loss/lr": ts.lr})
        ts.env_state, ts.obs, ts.iteration = env_state, obs, ts.iteration + 1
        return ts, log

    def train_iteration(self, ts: MimicTrainState):
        """Rollout + update in the iteration's mode: `learn(ts, rollout(ts))`."""
        return self.learn(ts, self.rollout(ts))


def add_teacher_obs_groups(cfg, teacher_cfg):
    """Make the student env compute the teacher's obs groups too, as
    `teacher_actor_obs` and `teacher_future_motion_targets`
    (`pbhc_tpu/train.py:145-156`). Changes `cfg` in place."""
    cfg.obs.obs_dict["teacher_actor_obs"] = list(teacher_cfg.obs.obs_dict["actor_obs"])
    cfg.obs.obs_dict["teacher_future_motion_targets"] = list(teacher_cfg.obs.obs_dict["future_motion_targets"])
    return cfg


def load_teacher(ckpt_path, teacher_cfg, env) -> Teacher:
    """The frozen teacher of a distillation run (`pbhc_tpu/train.py:315-358`):
    its net built from the TEACHER's config at the widths of the teacher
    groups of the student env, its weights from `ckpt_path`."""
    from pbhc_tpu_torch.agents.convert import from_flax
    from pbhc_tpu_torch.agents.mimic_networks import build_mimic_net
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

    payload = load_checkpoint_payload(ckpt_path)
    s_hist, t_hist = int(env.config.obs.history_length), int(teacher_cfg.obs.history_length)
    if s_hist != t_hist:
        raise ValueError(f"teacher history_length={t_hist} != student history_length={s_hist}; "
                         "distillation requires matching prop_history windows")
    net = build_mimic_net(teacher_cfg.algo.config, env.num_actions, env.obs_dim("teacher_actor_obs"),
                          env.obs_dim("priv_obs"), env.obs_dim("teacher_future_motion_targets"),
                          int(teacher_cfg.obs.future_num_steps), env.obs_dim("prop_history"), t_hist)
    params = payload["params"] if "params" in payload else payload["actor_params"]
    return Teacher(from_flax(params, net).to(env.device))
