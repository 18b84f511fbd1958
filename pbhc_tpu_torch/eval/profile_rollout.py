"""Where the serving rollout's time goes on the card.

Builds the env and actor of a checkpoint (default: the side-kick run's) as
`batch_eval.episode_ratio` does, steps
the rollout `warmup` times, then traces `steps` control steps with
`torch.profiler` and prints one JSON line: host wall time per control step
(synchronised), device-busy time per step (sum of the CUDA kernels' times on
the one stream), the busy share, CUDA kernels launched per step, the contact
kernels' device time per step, and the top ops by device time.

    python -m pbhc_tpu_torch.eval.profile_rollout [num_envs=4096] [steps=5] [warmup=3] [checkpoint=<pkl>] \
        [a.b.c=value ...]

Extra `a.b.c=value` arguments override the run config, as in `batch_eval`
(for example `simulator.config.solver=apgd` for the per-env engine).

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


def profile_rollout(num_envs=4096, steps=5, warmup=3, checkpoint=CKPT, overrides=()):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rollout measures the card: no CUDA device visible")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    env, actor, _ = batch_eval.load(checkpoint, num_envs, overrides, device=dev)
    state, obs = batch_eval.start_episodes(env)

    def run(n):
        nonlocal state, obs
        with torch.no_grad():
            for _ in range(n):
                state, obs, _, _, _ = env.step(state, batch_eval.act_mean(actor, obs))

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    return {"checkpoint": str(checkpoint), "num_envs": num_envs, "steps": steps, "overrides": list(overrides),
            **device_summary(prof, steps, wall_ms, "step"),
            "device": torch.cuda.get_device_name(dev)}


def device_summary(prof, n, wall_ms, unit):
    """Per `unit` (a step or an iteration, `n` of them traced) from a
    `torch.profiler` trace: the host wall ms (measured outside the trace), the
    device-busy ms (the CUDA kernels' times on the one stream), the busy share,
    CUDA kernels launched, each contact kernel's device ms, and the top aten
    ops by device time."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / n
    by_op = defaultdict(float)
    for e in prof.key_averages():
        if e.key.startswith("aten::") and e.self_device_time_total > 0:
            by_op[e.key] += e.self_device_time_total
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    out = {f"wall_ms_per_{unit}": wall_ms,
           f"device_busy_ms_per_{unit}": busy_ms if kernels else None,
           "device_busy_share": busy_ms / wall_ms if kernels else None,
           f"cuda_kernels_per_{unit}": len(kernels) / n}
    for name in ("apgd_lanes", "apgd_envfirst"):
        out[f"{name}_ms_per_{unit}"] = sum(e.device_time for e in kernels if name in e.name) / 1e3 / n
    out[f"top_ops_device_ms_per_{unit}"] = {k: v / 1e3 / n for k, v in top}
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv)
    args = {k: int(kv.pop(k)) for k in ("num_envs", "steps", "warmup") if k in kv}
    if "checkpoint" in kv:
        args["checkpoint"] = kv.pop("checkpoint")
    batch_eval.set_precision()
    print(json.dumps(profile_rollout(**args, overrides=[f"{k}={v}" for k, v in kv.items()])), flush=True)


if __name__ == "__main__":
    main()
