"""Where the serving rollout's time goes on the card.

Builds the env and actor of a checkpoint (default: the side-kick run's) as
`batch_eval.episode_ratio` does, steps
the rollout `warmup` times, then traces `steps` control steps with
`torch.profiler` and prints one JSON line: host wall time per control step
(synchronised), device-busy time per step (sum of the CUDA kernels' times on
the one stream), the busy share, CUDA kernels per step, the host's launch
calls per step, the contact kernels' device time per step, the top ops by
device time, and `by_span`: the step split by stage (the program's innermost
spans, `env.engine`, `engine.contact`, ...: device ms, kernels launched and
host syncs per step).

The stage split needs eager steps: a lanes control step that replays its
CUDA graphs (`sim/step_graph.py`) runs no op of its stages from Python. So
the lanes engine's `control_step_batched` is shadowed on the instance for
the traced steps, which keeps all five stages eager by the graphs' own rules
(`step_graph.engine_eligible`, `env_eligible`), and the same number of steps
as the env runs them, graphed, is traced besides: `graphed` holds their
summary (the engine's device time and kernels under `engine.graph_replay`,
each other stage's under `env.graph_replay`, in its `by_span`);
`stage_steps` counts the graphed and the eager calls of each stage, the
engine's among them.

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
from pbhc_tpu_torch.utils import profiling

CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
# the CUDA calls that launch work on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


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

    def traced():
        run(warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        return device_summary(prof, steps, wall_ms, "step", profiling.sessions()[-1])

    out = {"checkpoint": str(checkpoint), "num_envs": num_envs, "steps": steps, "overrides": list(overrides)}
    lanes = env.lanes_engine
    if lanes is None:
        return {**out, **traced(), "device": torch.cuda.get_device_name(dev)}
    graphed = traced()
    lanes.control_step_batched = lanes.control_step_batched
    try:
        eager = traced()
    finally:
        del lanes.control_step_batched
    return {**out, **eager, "device": torch.cuda.get_device_name(dev), "graphed": graphed,
            "stage_steps": {k: dict(v) for k, v in env.stage_graphs.counts.items()}}


def device_summary(prof, n, wall_ms, unit, records):
    """Per `unit` (a step or an iteration, `n` of them traced) from a
    `torch.profiler` trace: the host wall ms (measured outside the trace), the
    device-busy ms (the CUDA kernels' times on the one stream), the busy share,
    CUDA kernels run, the host's launch calls (`LAUNCHES`: a graph replay is
    one), each contact kernel's device ms, the top aten ops by device time,
    and the split by the program's spans, whose `records` the trace made
    (`by_span`)."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.name in LAUNCHES for e in prof.events())
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / n
    by_op = defaultdict(float)
    for e in prof.key_averages():
        if e.key.startswith("aten::") and e.self_device_time_total > 0:
            by_op[e.key] += e.self_device_time_total
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    out = {f"wall_ms_per_{unit}": wall_ms,
           f"device_busy_ms_per_{unit}": busy_ms if kernels else None,
           "device_busy_share": busy_ms / wall_ms if kernels else None,
           f"cuda_kernels_per_{unit}": len(kernels) / n,
           f"host_launches_per_{unit}": launches / n}
    for name in ("apgd_lanes", "apgd_envfirst"):
        out[f"{name}_ms_per_{unit}"] = sum(e.device_time for e in kernels if name in e.name) / 1e3 / n
    out[f"top_ops_device_ms_per_{unit}"] = {k: v / 1e3 / n for k, v in top}
    out["by_span"] = by_span(prof, records, n)
    return out


def by_span(prof, records, n):
    """{span: {"device_ms", "kernels", "host_syncs"}} per unit: each kernel
    credited to the innermost program span around the op that launched it
    (the kernel's correlation with its launching op; kernels launched outside
    every span under "(none)"), each host sync to the span it was counted in."""
    names = {r.name for r in records}
    out = {}

    def entry(name):
        return out.setdefault(name, {"device_ms": 0.0, "kernels": 0.0, "host_syncs": 0.0})

    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and op.name not in names:
            op = op.cpu_parent
        t = entry("(none)" if op is None else op.name)
        t["device_ms"] += sum(k.duration for k in e.kernels) / 1e3 / n
        t["kernels"] += len(e.kernels) / n
    for r in records:
        entry(r.name)["host_syncs"] += r.syncs / n
    return {k: out[k] for k in sorted(out, key=lambda k: -out[k]["device_ms"])}


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
