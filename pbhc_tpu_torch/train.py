"""Training CLI (counterpart of `pbhc_tpu/train.py`).

Usage (the selections of `bench.py`; the port has a config snapshot for them):
    python -m pbhc_tpu_torch.train exp=motion_tracking robot=g1_23dof \\
        obs=motion_tracking rewards=motion_tracking domain_rand=main simulator=tpu \\
        num_envs=4096 robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl \\
        algo.config.num_learning_iterations=<n> [simulator.config.solver=pallas] [device=cpu]

It runs on the first CUDA card unless `device=` names another device. It
writes a run directory `<base_dir>/<project_name>/<time>-<experiment>-<task>/`
holding the composed config as `config.json` and the checkpoints as
`ckpt/model_<it>.pkl` (flax-layout params, which `pbhc_tpu` loads too), saved
every `save_interval` iterations and at the end, and prints the JAX CLI's log
line with window-based fps, plus the rollout and update seconds of the
logged iteration.

Not ported yet (ROADMAP queue 1 item 9): resume from a checkpoint (with or
without optimizer state), teacher loading, TensorBoard, wandb, the watchdog
and multi-device training.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from pbhc_tpu_torch.agents.mh_ppo import MHPPO
from pbhc_tpu_torch.config.loader import compose, parse_cli
from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
from pbhc_tpu_torch.eval.batch_eval import ENV_TARGET, set_precision
from pbhc_tpu_torch.utils.checkpoint import save_checkpoint

ALGO_TARGET = "pbhc_tpu.agents.mh_ppo.MHPPO"


def build(cfg):
    """(env, algo, train state) for a composed config, on `cfg.device`
    (default cuda), in float32 with TF32 off."""
    set_precision()
    if cfg.env.target != ENV_TARGET or cfg.algo.target != ALGO_TARGET:
        raise NotImplementedError(f"{cfg.env.target} with {cfg.algo.target} is not ported "
                                  "(ROADMAP queue 1 item 11)")
    for key, what in (("checkpoint", "resume from a checkpoint"),
                      ("auto_load_latest", "resume from a checkpoint"),
                      ("use_wandb", "wandb logging")):
        if cfg.get(key):
            raise NotImplementedError(f"{key}: {what} is not ported yet (ROADMAP queue 1 item 9)")
    if cfg.algo.config.get("teacher_model_path"):
        raise NotImplementedError("teacher loading is ROADMAP queue 1 item 11")
    seed = int(cfg.seed)
    env = MotionTrackingEnv(cfg, int(cfg.num_envs), device=cfg.get("device", "cuda"), seed=seed)
    algo = MHPPO(cfg, env, seed=seed)
    return env, algo, algo.init_train_state()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns the algorithm, the final train state and the log of every
    printed iteration (with its fps and its rollout and update seconds)."""
    argv = sys.argv[1:] if argv is None else argv
    sels, ovs = parse_cli(argv)
    cfg = compose(sels, ovs)

    timestamp = time.strftime("%Y%m%d_%H%M%S")
    exp_dir = (Path(cfg.base_dir) / cfg.project_name
               / f"{timestamp}-{cfg.experiment_name}-{cfg.get('log_task_name', 'task')}")
    exp_dir.mkdir(parents=True, exist_ok=True)
    (exp_dir / "config.json").write_text(json.dumps(cfg, indent=1))
    print(f"[train] experiment dir: {exp_dir}")

    env, algo, ts = build(cfg)
    dev = env.device
    print(f"[train] device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    num_iters = int(cfg.algo.config.num_learning_iterations)
    if cfg.get("total_iterations"):   # cumulative target; without resume it starts at 0
        num_iters = max(0, int(cfg.total_iterations) - ts.iteration)
    save_interval = int(cfg.algo.config.save_interval)
    log_interval = max(1, int(cfg.algo.config.get("logging_interval", 25)) // 5)
    steps_per_iter = env.num_envs * algo.num_steps
    ckpt_dir = exp_dir / "ckpt"
    logs = []

    t_start = time.time()
    last_log_t, last_log_it = t_start, 0
    for it in range(num_iters):
        t0 = time.time()
        if it == 2:
            # as the JAX CLI does: iterations 0 and 1 (there: compiles; here:
            # kernel builds and library warm-up) stay out of the fps windows
            last_log_t, last_log_it = t0, 2
        log_now = (it + 1) % log_interval == 0 or it == 0
        rollout = algo.rollout(ts)
        if log_now:
            # rollout seconds: from the iteration's start on the host to the
            # rollout's end on the device (earlier unsynchronised iterations'
            # device work included)
            _sync(dev)
            t_mid = time.time()
        ts, log = algo.learn(ts, rollout)
        if it == 0:
            _sync(dev)
            print(f"[train] first iteration (incl. kernel builds): {time.time() - t0:.1f}s")
        if log_now:
            log = {k: float(v) for k, v in log.items()}      # waits for the whole window
            now = time.time()
            window_iters = 1 if it == 0 else (it + 1 - last_log_it)
            fps = steps_per_iter * window_iters / (now - last_log_t)
            last_log_t, last_log_it = now, it + 1
            logs.append(dict(log, iteration=it + 1, fps=fps, rollout_s=t_mid - t0, update_s=now - t_mid))
            print(f"[it {it + 1}/{num_iters}] rew/step={log['Train/mean_step_reward']:.4f} "
                  f"epl={log['Env/episode_length_mean']:.1f} kl={log['Loss/kl']:.4f} "
                  f"lr={log['Loss/lr']:.2e} fps={fps:,.0f} "
                  f"rollout/update={t_mid - t0:.2f}/{now - t_mid:.2f}s", flush=True)
        if (it + 1) % save_interval == 0 and it + 1 < num_iters:
            print(f"[train] saved {save_checkpoint(ckpt_dir, ts)}")
    _sync(dev)
    print(f"[train] done in {time.time() - t_start:.0f}s")
    print(f"[train] saved {save_checkpoint(ckpt_dir, ts)}")
    return algo, ts, logs


if __name__ == "__main__":
    main()
