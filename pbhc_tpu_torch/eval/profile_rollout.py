"""Where the serving rollout's time goes on the card.

Builds the side-kick env and actor as `batch_eval.episode_ratio` does, steps
the rollout `warmup` times, then traces `steps` control steps with
`torch.profiler` and prints one JSON line: host wall time per control step
(synchronised), device-busy time per step (sum of the CUDA kernels' times on
the one stream), the busy share, CUDA kernels launched per step, the
`apgd_lanes` kernel's device time per step, and the top ops by device time.

    python -m pbhc_tpu_torch.eval.profile_rollout [num_envs=4096] [steps=5] [warmup=3]

Needs a CUDA card; it does not fall back to the CPU.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch

from pbhc_tpu_torch.eval import batch_eval

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"


def profile_rollout(num_envs=4096, steps=5, warmup=3):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rollout measures the card: no CUDA device visible")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    env, actor, _ = batch_eval.load(CKPT, num_envs, device=dev)
    state, obs = batch_eval.start_episodes(env)

    def run(n):
        nonlocal state, obs
        with torch.no_grad():
            for _ in range(n):
                state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    apgd_us = sum(e.device_time for e in kernels if "apgd_lanes" in e.name)
    by_op = defaultdict(float)
    for e in prof.key_averages():
        if e.key.startswith("aten::") and e.self_device_time_total > 0:
            by_op[e.key] += e.self_device_time_total
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {
        "num_envs": num_envs, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_us / 1e3 / steps if kernels else None,
        "device_busy_share": (busy_us / 1e3 / steps) / wall_ms if kernels else None,
        "cuda_kernels_per_step": len(kernels) / steps,
        "apgd_lanes_ms_per_step": apgd_us / 1e3 / steps if kernels else None,
        "top_ops_device_ms_per_step": {k: v / 1e3 / steps for k, v in top},
        "device": torch.cuda.get_device_name(dev),
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = {k: int(v) for k, v in (a.split("=", 1) for a in argv)}
    batch_eval.set_precision()
    print(json.dumps(profile_rollout(**kv)), flush=True)


if __name__ == "__main__":
    main()
