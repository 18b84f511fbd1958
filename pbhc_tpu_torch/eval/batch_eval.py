"""Batch evaluation on the port (counterpart of `pbhc_tpu/eval/batch_eval.py`).

* `episode_ratio` (`:50-101`): early termination ON, every env playing the
  clip from t = 0: the mean first-termination step and its ratio to the clip
  length, plus the control steps per second of the rollout.
* `sample_episodes` (`:104-134`): the three early terminations OFF, the
  accuracy and smoothness families of env 0 over whole clips, mean and std
  over the episodes.

CLI (the JAX CLI's keys, plus `device=`):
    python -m pbhc_tpu_torch.eval.batch_eval \
        checkpoint=artifacts/kb1_side_kick/ckpt/model_10500.pkl mode=ratio|sample_episodes num_envs=4096
Extra `a.b.c=value` arguments override the run config.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from pbhc_tpu_torch.agents.convert import from_flax
from pbhc_tpu_torch.agents.mimic_networks import MimicActorCritic, mimic_net_from_config
from pbhc_tpu_torch.agents.networks import actor_from_config, phase_embed_config, phase_position
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
from pbhc_tpu_torch.eval.metrics import eval_accuracy, eval_smoothness
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

ENV_TARGET = "pbhc_tpu.envs.tracking_env.MotionTrackingEnv"
GENERAL_ENV_TARGET = "pbhc_tpu.envs.general_tracking_env.GeneralTrackingEnv"
ENVS = {ENV_TARGET: MotionTrackingEnv, GENERAL_ENV_TARGET: GeneralTrackingEnv}


def set_precision():
    """Full f32 products: the engine's root-anchored spatial math relies on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load(ckpt_path, num_envs, overrides=(), device="cuda", seed=0):
    """(env, actor, cfg) for the run that wrote `ckpt_path` (`batch_eval.py:24`):
    a `MotionTrackingEnv` and `GaussianActor` (or `PhaseAwareActor`) for an MHPPO run, a
    `GeneralTrackingEnv` and `MimicActorCritic` for a PPOMimic one."""
    set_precision()
    cfg = snapshot_for_checkpoint(ckpt_path)
    cfg["num_envs"] = num_envs
    cfg = Cfg.wrap(apply_overrides(cfg, overrides))
    if cfg.env.target not in ENVS:
        raise NotImplementedError(f"env {cfg.env.target} is not ported")
    env = ENVS[cfg.env.target](cfg, num_envs, device=device, seed=seed)
    payload = load_checkpoint_payload(ckpt_path)
    if cfg.env.target == GENERAL_ENV_TARGET:
        actor = from_flax(payload["params"], mimic_net_from_config(cfg, env.num_actions))
    else:
        params = payload.get("actor_params") or payload.get("params")
        pos = phase_position(env, "actor_obs") if phase_embed_config(cfg)[0] != "Original" else None
        actor = from_flax(params, actor_from_config(cfg, env.obs_dim("actor_obs"), env.num_actions, pos))
    return env, actor.to(env.device).eval(), cfg


def act_mean(actor, obs):
    """The deterministic action of a loaded actor (`batch_eval.py:66-81`): a
    `MimicActorCritic` acts through its history latent."""
    if isinstance(actor, MimicActorCritic):
        return actor.act(obs, True)[0]
    return actor(obs["actor_obs"])[0]


def start_episodes(env):
    """Every env at clip time 0 with its first observations (`batch_eval.py:61-64`)."""
    state = env.reset_to_start(env.init_state())
    obs, hist = env.compute_observations(state)
    state.history = hist
    return state, obs


def rollout_ratio(env, actor, state, obs, num_steps):
    """Step `num_steps` times under the actor's mean action. Returns the final
    state, per env the first step at which it terminated other than by motion
    end (`num_steps` if never), and the count of env-steps that ended in a
    non-finite state. Stays on the device until the end."""
    N = env.num_envs
    first = torch.full((N,), num_steps, dtype=torch.int64, device=env.device)
    nonfinite = torch.zeros((), dtype=torch.int64, device=env.device)
    with torch.no_grad():
        for i in range(num_steps):
            state, obs, _, done, info = env.step(state, act_mean(actor, obs))
            failed = done & ~info["time_outs"]
            first = torch.where((first == num_steps) & failed, i, first)
            nonfinite = nonfinite + info["nonfinite"].sum()
    return state, first, nonfinite


def episode_ratio(ckpt_path, num_envs=64, overrides=(), device="cuda"):
    """`batch_eval.py:50`: returns the JAX harness's keys plus
    `control_steps_per_sec` (host clock over the whole rollout, synchronised)."""
    env, actor, _ = load(ckpt_path, num_envs, overrides, device)
    state, obs = start_episodes(env)
    Mi = torch.ceil(state.motion_len / env.dt).to(torch.int64)
    M = int(Mi.max())
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    t0 = time.perf_counter()
    state, first, nonfinite = rollout_ratio(env, actor, state, obs, M)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    secs = time.perf_counter() - t0
    first = torch.minimum(first, Mi)
    per_env = (first.to(torch.float64) / Mi).cpu()
    return {
        "mean_first_termination_step": float(first.to(torch.float64).mean()),
        "episode_steps": M,
        "ratio": float(per_env.mean()),
        "ratio_std": float(per_env.std(unbiased=False)),
        "completed_frac": float((first >= Mi).to(torch.float64).mean()),
        "episodes": int(num_envs),
        "control_steps_per_sec": M / secs,
        "nonfinite_env_steps": int(nonfinite),
        "device": torch.cuda.get_device_name(env.device) if env.device.type == "cuda" else "cpu",
    }


# the terminations `sample_episodes` turns off, so that every episode plays the whole clip
NO_TERMINATION = ("env.config.termination.terminate_when_motion_far=false",
                  "env.config.termination.terminate_by_gravity=false",
                  "env.config.termination.terminate_when_dof_far=false")


def sample_episodes(ckpt_path, num_envs=4, episodes=8, overrides=(), device="cuda"):
    """`batch_eval.py:104`: max(1, episodes // num_envs) rollouts of the whole
    clip with early termination off; per family the mean and std over them.
    Each rollout resets the envs to clip time 0 and draws new randomisation
    from the env's generator."""
    from pbhc_tpu_torch.eval_agent import clip_steps, rollout   # eval_agent imports this module

    env, actor, _ = load(ckpt_path, num_envs, list(overrides) + list(NO_TERMINATION), device)
    num_steps = clip_steps(env)
    families = []
    for _ in range(max(1, episodes // num_envs)):
        traj, ref, _ = rollout(env, actor, num_steps)
        families.append({**eval_accuracy(traj, ref, env.dt), **eval_smoothness(traj, env.dt, ref=ref)})
    return {k: {"mean": float(np.mean([f[k] for f in families])), "std": float(np.std([f[k] for f in families]))}
            for k in families[0]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    ckpt = kv.pop("checkpoint")
    mode = kv.pop("mode", "ratio")
    num_envs = int(kv.pop("num_envs", 16))
    device = kv.pop("device", "cuda")
    overrides = [f"{k}={v}" for k, v in kv.items()]
    if mode == "ratio":
        out = episode_ratio(ckpt, num_envs, overrides=overrides, device=device)
    elif mode in ("sample", "sample_episodes"):
        out = sample_episodes(ckpt, num_envs, overrides=overrides, device=device)
    else:
        raise ValueError(f"mode={mode!r}: want ratio or sample_episodes")
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
