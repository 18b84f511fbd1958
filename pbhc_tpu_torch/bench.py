"""Training throughput of the port (counterpart of the repo's `bench.py`).

A complete MHPPO iteration (24-step rollout + minibatched update, what
`python -m pbhc_tpu_torch.train` loops) at 4096 G1 23-DoF envs with full
domain randomisation, reported as env-steps/s: 2 warm-up iterations, then 20
timed ones with the device synchronised before the clock is read.

    python -m pbhc_tpu_torch.bench [num_envs] [lanes|pallas] [device=cpu]

Prints one JSON line, `bench.py`'s keys plus the solver, env count and
device: {"metric": "train_env_steps_per_sec", "value", "unit", "vs_baseline",
"solver", "num_envs", "device"}. The baseline is `bench.py`'s: ~50k
env-steps/s, published Isaac Gym legged-gym throughput at 4096 envs.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from pbhc_tpu_torch.config.loader import compose
from pbhc_tpu_torch.train import build

SELECTIONS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking",
              "rewards=motion_tracking", "domain_rand=main", "simulator=tpu"]
MOTION = "assets/motions/Horse-stance_punch.pkl"
BASELINE = 50_000.0


def run(num_envs=4096, solver="lanes", device="cuda", iters=20, warmup=2) -> dict:
    cfg = compose(SELECTIONS, [f"num_envs={num_envs}", f"robot.motion.motion_file={MOTION}",
                               f"simulator.config.solver={solver}", f"device={device}"])
    env, algo, ts = build(cfg)
    dev = env.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        ts, _ = algo.train_iteration(ts)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, _ = algo.train_iteration(ts)
    sync()
    eps = algo.num_steps * num_envs * iters / (time.perf_counter() - t0)
    return {"metric": "train_env_steps_per_sec", "value": round(eps, 1), "unit": "env-steps/s",
            "vs_baseline": round(eps / BASELINE, 3), "solver": solver, "num_envs": num_envs,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if "=" not in a]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = run(int(pos[0]) if pos else 4096, pos[1] if len(pos) > 1 else "lanes",
              kv.get("device", "cuda"))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
