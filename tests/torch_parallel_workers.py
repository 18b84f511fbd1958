"""What the ranks of `tests/test_torch_parallel.py` run (imports no JAX, so
that a spawned rank starts quickly). Each scenario runs in a process group
that `parallel/mesh.run_ranks` set up, or in the test process itself with
no group: the one-rank reference. Inputs arrive as numpy arrays; results
leave as numpy arrays and floats."""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from pbhc_tpu_torch.agents import convert
from pbhc_tpu_torch.agents.mh_ppo import MHPPO
from pbhc_tpu_torch.agents.networks import MoEMLP, actor_from_config, critic_from_config
from pbhc_tpu_torch.agents.ppo_mimic import OBS_KEYS
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, compose, load_snapshot
from pbhc_tpu_torch.envs import tracking_env
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
from pbhc_tpu_torch.parallel.mesh import make_mesh, replica_checksum

V1 = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking", "rewards=motion_tracking",
      "domain_rand=main", "simulator=tpu"]
TEACHER = "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl"
SCALARS = ("sigma_values", "sigma_ema", "average_episode_length", "reward_penalty_scale",
           "motion_far_threshold", "dof_far_threshold", "soft_dof_pos_limit", "soft_dof_vel_limit",
           "soft_torque_limit", "noise_curriculum_value", "motion_fail_ema")


def _np(x):
    return x.detach().cpu().numpy().copy()


def _local(tree, shard, axis):
    """The rank's envs of every array of `tree` (env axis `axis`)."""
    sl = (slice(None),) * axis + (slice(shard.offset, shard.offset + shard.local_envs),)
    return {k: torch.as_tensor(np.ascontiguousarray(v[sl])) for k, v in tree.items()}


def prime(opt, seed, scale=1e-3, lr=1e-3, skip=()):
    """One Adam step on random gradients from `seed` (zero for the params of
    `skip`), so that an update starts from a mid-training optimizer state."""
    rng = np.random.default_rng(seed)
    skip = {id(p) for p in skip}
    grads = [torch.zeros_like(p) if id(p) in skip else
             torch.as_tensor((scale * rng.normal(size=tuple(p.shape))).astype(np.float32)) for p in opt.params]
    opt.step(grads, torch.tensor(lr))


# ------------------------------------------------------------------ MHPPO
def mhppo_learn(ovs, state, traj, last_obs, perms):
    """`MHPPO.learn` on this rank's envs of `traj` ([T,N,...]), from the
    train state `state` (flax params, optimizer states and lr), with the
    global permutations `perms`."""
    cfg = compose(V1, ovs + ["device=cpu"])
    shard = make_mesh(int(cfg.num_envs), "cpu")
    algo = MHPPO(cfg, MotionTrackingEnv(cfg, shard.local_envs, device="cpu", shard=shard))
    actor = convert.from_flax(state["actor"], actor_from_config(cfg, algo.actor_dim, algo.num_act))
    critic = convert.from_flax(state["critic"], critic_from_config(cfg, algo.critic_dim, algo.num_rew))
    ts = algo.new_train_state(actor, critic)
    ts.actor_opt.load_state_dict(state["actor_opt"])
    ts.critic_opt.load_state_dict(state["critic_opt"])
    ts.lr = torch.tensor(state["lr"])
    ts, log = algo.learn(ts, (None, _local(last_obs, shard, 0), _local(traj, shard, 1), {}),
                         perms=[torch.as_tensor(p) for p in perms])
    return {"actor": convert.flax_params(ts.actor), "critic": convert.flax_params(ts.critic),
            "lr": float(ts.lr), "log": {k: float(v) for k, v in log.items()}}


# ---------------------------------------------------------------- PPOMimic
def mimic_config(run, extra, num_envs):
    return Cfg.wrap(apply_overrides(load_snapshot(run), [
        "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl", f"num_envs={num_envs}", "device=cpu",
        *extra]))


def mimic_algo(run, extra, num_envs, seed):
    """(algo, train state) of a KungfuBot2 snapshot on this rank's envs, its
    optimizers primed by one shared step."""
    from pbhc_tpu_torch import train

    cfg = mimic_config(run, extra, num_envs)
    _, algo, ts = train.build(cfg, make_mesh(num_envs, "cpu"))
    hist = list(ts.net.actor.history_encoder.parameters())
    prime(ts.opt, seed, lr=1e-4, skip=hist if algo.dagger_only else ())
    prime(ts.hist_opt, seed + 1, lr=algo.learning_rate)
    return algo, ts


def mimic_traj(algo, ts, T, rng, shift=0.05):
    """A [T,N] trajectory whose observations are drawn from `rng` and whose
    old policy is `ts.net`'s with its mean moved by `shift`."""
    env, N = algo.env, algo.env.num_envs
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    keys = OBS_KEYS + (("teacher_actor_obs", "teacher_future_motion_targets") if algo.teacher else ())
    obs = {k: f32(rng.normal(size=(T, N, env.obs_dim(k)))) for k in keys}
    flat = {k: torch.as_tensor(v.reshape(T * N, -1)) for k, v in obs.items()}
    with torch.no_grad():
        mean, std = (_np(x).reshape(T, N, -1) for x in ts.net.act(flat, False))
        values = _np(ts.net.evaluate(flat)).reshape(T, N, -1)
        teacher = _np(algo.teacher(flat)).reshape(T, N, -1) if algo.teacher else None
    old_mean = f32(mean + shift * rng.normal(size=mean.shape))
    old_std = f32(std * np.exp(0.05 * rng.normal(size=mean.shape)))
    actions = f32(old_mean + old_std * rng.normal(size=mean.shape))
    logp = f32((-0.5 * ((actions - old_mean) / old_std) ** 2 - np.log(old_std) - 0.5 * np.log(2 * np.pi)).sum(-1))
    traj = {k: obs[k] for k in OBS_KEYS}
    traj.update(actions=actions, logp=logp, mean=old_mean, std=old_std, values=values,
                rewards=f32(0.1 * rng.normal(size=values.shape)), dones=rng.uniform(size=(T, N)) < 0.05)
    if teacher is not None:
        traj["teacher_actions"] = teacher
    last = {k: f32(rng.normal(size=(N, env.obs_dim(k)))) for k in OBS_KEYS}
    return traj, last


def _averaged_local_moe_loss(self, x, dp=None):
    """The load-balance loss as the mean of every rank's loss over its own
    rows (local f and P, scaled by 1/world): what DP must not compute."""
    out, lb = MoEMLP._forward(self, x)
    world = dp[0].world if dp is not None else 1
    return out, lb / world


def mimic_learn(run, extra, num_envs, seed, traj, last_obs, perms, hist_encoding, average_local_lb=False):
    """`PPOMimic.learn` on this rank's envs of `traj`; with
    `average_local_lb`, under the loss of `_averaged_local_moe_loss`."""
    algo, ts = mimic_algo(run, extra, num_envs, seed)
    shard = algo.shard
    if average_local_lb:
        MoEMLP._forward, MoEMLP.forward = MoEMLP.forward, _averaged_local_moe_loss
    try:
        ts, log = algo.learn(ts, (None, _local(last_obs, shard, 0), _local(traj, shard, 1), {}, hist_encoding),
                             perms=None if perms is None else [torch.as_tensor(p) for p in perms])
    finally:
        if average_local_lb:
            MoEMLP.forward = MoEMLP._forward
            del MoEMLP._forward
    return {"net": convert.flax_params(ts.net), "lr": float(ts.lr),
            "log": {k: float(v) for k, v in log.items()}}


# -------------------------------------------------------------------- env
def _injected(offset, num_all):
    """Deterministic stand-ins for the reset's two draws, functions of each
    env's index on the global env axis and of the call count: motion ids by
    the inverse CDF of the sampling probabilities, start times as a phase of
    the clip."""
    calls = {"ids": 0, "time": 0}

    def quantiles(n, key):
        k = calls[key]
        calls[key] += 1
        g = torch.arange(n, dtype=torch.float64) + offset
        return torch.frac(0.5 + 0.6180339887 * (g + 1) + 0.4142135623 * k * (g + 3) / num_all)

    def multinomial(probs, n, replacement=True, generator=None):
        cdf = torch.cumsum(probs.double(), 0)
        u = quantiles(n, "ids").to(probs.device) * cdf[-1]
        return torch.clamp(torch.searchsorted(cdf, u), max=len(probs) - 1)

    def sample_time(data, motion_ids, generator, truncate_time=None):
        return quantiles(motion_ids.shape[0], "time").to(torch.float32) * data.lengths[motion_ids]

    return multinomial, sample_time


def env_scalars(ovs, actions):
    """`K = len(actions)` control steps of the v1 env on this rank's envs with
    the reset draws injected; the replicated scalars and the step logs after
    each step, and the rank's per-env done flags and reward vectors."""
    cfg = compose(V1, ovs + ["device=cpu"])
    shard = make_mesh(int(cfg.num_envs), "cpu")
    multinomial, sample_time = _injected(shard.offset, shard.num_envs)
    saved = torch.multinomial, tracking_env.sample_time
    torch.multinomial, tracking_env.sample_time = multinomial, sample_time
    try:
        env = MotionTrackingEnv(cfg, shard.local_envs, device="cpu", shard=shard)
        state = env.init_state()
        state.history = env.compute_observations(state)[1]
        out = {"scalars": [], "logs": [], "dones": [], "rewards": [], "num_unique": env.motion_lib.num_unique}
        with torch.no_grad():
            for a in actions:
                state, _, rew, done, info = env.step(state, torch.as_tensor(a[shard.offset:shard.offset + shard.local_envs]))
                out["scalars"].append({k: _np(getattr(state, k)) for k in SCALARS})
                out["logs"].append(info["log"])
                out["dones"].append(_np(done))
                out["rewards"].append(_np(rew))
    finally:
        torch.multinomial, tracking_env.sample_time = saved
    logs = env.global_logs({k: torch.stack([x[k] for x in out["logs"]]) for k in out["logs"][0]})
    out["logs"] = [{k: float(v[i]) for k, v in logs.items()} for i in range(len(actions))]
    return out


# ------------------------------------------------------------------ draws
def draws(num_envs):
    """Draws from the env's and the learner's generators."""
    cfg = compose(V1, [f"num_envs={num_envs}", "device=cpu",
                       "robot.motion.motion_file=assets/motions/Horse-stance_pose.pkl"])
    shard = make_mesh(num_envs, "cpu")
    algo = MHPPO(cfg, env := MotionTrackingEnv(cfg, shard.local_envs, device="cpu", shard=shard))
    return {"env": _np(torch.rand(8, generator=env.gen)), "env_shared": _np(torch.rand(8, generator=env.shared_gen)),
            "actions": _np(torch.randn(8, generator=algo.gen)),
            "perm": _np(torch.randperm(64, generator=algo.perm_gen))}


# ------------------------------------------------------------------ train
def train_main(argv, base_dir):
    """The training CLI; its logs, the train state's checksum and the
    checkpoints under `base_dir` (only rank 0 writes any)."""
    from pbhc_tpu_torch import train

    _, ts, logs = train.main(argv)
    return {"logs": logs, "checksum": float(replica_checksum(ts)),
            "ckpts": sorted(glob.glob(os.path.join(base_dir, "**", "model_*.pkl"), recursive=True)),
            "params": convert.flax_params(ts.actor)}


def fail_on_rank_1():
    """Raises on rank 1 only (rank 0 returns)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return 0


SCENARIOS = {f.__name__: f for f in (mhppo_learn, mimic_learn, env_scalars, draws, train_main)}


def rank_main(spec):
    """Every (name, kwargs) of `spec` in turn: {name: result}."""
    return {name: SCENARIOS[name.split(":")[0]](**kwargs) for name, kwargs in spec}
