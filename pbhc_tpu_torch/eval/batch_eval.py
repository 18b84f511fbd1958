"""Episode-ratio evaluation on the port (counterpart of
`pbhc_tpu/eval/batch_eval.py::episode_ratio`, `:50-101`).

Early termination ON, every env playing the clip from t = 0: the mean
first-termination step and its ratio to the clip length, plus the control
steps per second of the rollout.

CLI (the JAX CLI's keys, plus `device=`):
    python -m pbhc_tpu_torch.eval.batch_eval \
        checkpoint=artifacts/kb1_side_kick/ckpt/model_10500.pkl mode=ratio num_envs=4096
Extra `a.b.c=value` arguments override the run config.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from pbhc_tpu_torch.agents.convert import actor_from_flax
from pbhc_tpu_torch.agents.networks import actor_from_config
from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, snapshot_for_checkpoint
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

ENV_TARGET = "pbhc_tpu.envs.tracking_env.MotionTrackingEnv"


def set_precision():
    """Full f32 products: the engine's root-anchored spatial math relies on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load(ckpt_path, num_envs, overrides=(), device="cuda", seed=0):
    """(env, actor, cfg) for the run that wrote `ckpt_path` (`batch_eval.py:24`)."""
    set_precision()
    cfg = snapshot_for_checkpoint(ckpt_path)
    cfg["num_envs"] = num_envs
    cfg = Cfg.wrap(apply_overrides(cfg, overrides))
    if cfg.env.target != ENV_TARGET:
        raise NotImplementedError(f"env {cfg.env.target} is not ported (ROADMAP queue 1 item 11)")
    env = MotionTrackingEnv(cfg, num_envs, device=device, seed=seed)
    payload = load_checkpoint_payload(ckpt_path)
    params = payload.get("actor_params") or payload.get("params")
    actor = actor_from_config(cfg, env.obs_dim("actor_obs"), env.num_actions)
    actor = actor_from_flax(params, actor).to(env.device).eval()
    return env, actor, cfg


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
            mean, _ = actor(obs["actor_obs"])
            state, obs, _, done, info = env.step(state, mean)
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    ckpt = kv.pop("checkpoint")
    mode = kv.pop("mode", "ratio")
    num_envs = int(kv.pop("num_envs", 16))
    device = kv.pop("device", "cuda")
    if mode != "ratio":
        raise NotImplementedError(f"mode={mode!r}: sample_episodes is ROADMAP queue 1 item 13")
    out = episode_ratio(ckpt, num_envs, overrides=[f"{k}={v}" for k, v in kv.items()], device=device)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
