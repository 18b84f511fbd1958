"""Where a training iteration's time goes on the card.

Builds `pbhc_tpu_torch.bench`'s configuration (G1 23-DoF, full domain
randomisation) for one solver, runs `warmup` training iterations, then for
each of the two phases of `MHPPO.train_iteration`, the rollout and the update
(`learn`), measures the synchronised host wall time of `iters` iterations and
traces them with `torch.profiler`. Prints one JSON line per phase with
`profile_rollout.device_summary`'s fields per iteration: wall ms, device-busy
ms and share, CUDA kernels, the contact kernels' ms and the top aten ops.

    python -m pbhc_tpu_torch.eval.profile_train [num_envs=4096] [solver=lanes] [iters=1] [warmup=2]

Needs a CUDA card; it does not fall back to the CPU. The trace of a rollout
holds ~200k CUDA kernels per iteration and the profiler takes minutes to
process it (two solvers at iters=2 took ~13 minutes on an H100 machine).
"""
from __future__ import annotations

import json
import sys
import time

import torch

from pbhc_tpu_torch.bench import MOTION, SELECTIONS
from pbhc_tpu_torch.config.loader import compose
from pbhc_tpu_torch.eval.profile_rollout import device_summary
from pbhc_tpu_torch.train import build


def profile_train(num_envs=4096, solver="lanes", iters=1, warmup=2):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device visible")
    from torch.profiler import ProfilerActivity, profile

    cfg = compose(SELECTIONS, [f"num_envs={num_envs}", f"robot.motion.motion_file={MOTION}",
                               f"simulator.config.solver={solver}"])
    env, algo, ts = build(cfg)
    for _ in range(warmup):
        ts, _ = algo.train_iteration(ts)
    torch.cuda.synchronize()

    rollouts = []
    phases = {"rollout": lambda: rollouts.append(algo.rollout(ts)),
              "update": lambda: algo.learn(ts, rollouts.pop(0))}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    walls = {name: wall_ms(fn) for name, fn in phases.items()}
    lines = []
    for name, fn in phases.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        lines.append({"phase": name, "solver": solver, "num_envs": num_envs, "iters": iters,
                      **device_summary(prof, iters, walls[name], "iteration"),
                      "device": torch.cuda.get_device_name(env.device)})
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    kw = {k: (v if k == "solver" else int(v)) for k, v in kv.items()}
    for line in profile_train(**kw):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
