"""What the per-layer readers (`portbench/metrics/<metric>.py`) share: each
reader is `read(ctx) -> float | None`, with `ctx` the run's window counts,
host spans, reduced profiler slices, configuration and mix; None leaves the
metric out of the line (the reader found nothing to read)."""
from __future__ import annotations

import statistics

from portbench.counts import work


def share(value: float, name: str) -> float:
    """A share of a roofline or a peak, in %: a count of work too high, or a
    time that leaves part of the work out, shows as a share over 105%, and
    one that is not above 0 read nothing; either fails the run."""
    if not 0.0 < value <= 105.0:
        raise ValueError(f"{name} reads {value!r}%: the work or the time is miscounted")
    return value


def p95(values) -> float:
    """The 95th percentile, nearest rank over every value."""
    v = sorted(values)
    return v[max(0, -(-95 * len(v) // 100) - 1)]


def span_mean(ctx, name):
    s = ctx["spans"].get(name)
    return statistics.fmean(s) if s else None


def slices(ctx, label):
    return [s for s in ctx["slices"] if s["label"] == label]


def kernel_seconds_per_launch(ctx, labels, pattern):
    """Device seconds per launch of the kernels whose name holds `pattern`."""
    secs = count = 0
    for s in ctx["slices"]:
        if s["label"] in labels:
            for name, k in s["kernels"].items():
                if pattern in name:
                    secs += k["seconds"]
                    count += k["count"]
    return secs / count if count else None


def apgd_lanes_roofline(ctx, labels):
    t = kernel_seconds_per_launch(ctx, labels, "apgd_lanes")
    if t is None:
        return None
    c = ctx["config"]
    bound = work.apgd_lanes_bound_s(c["contact_rows"], c["num_envs"], c["solver_iters"])
    return share(100.0 * bound / t, "apgd_lanes_roofline")


def idle_share_train(ctx):
    """Idle share of one iteration, from the profiled control steps of its
    rollout, scaled to the rollout's length, and its profiled update."""
    r, u = slices(ctx, "rollout"), slices(ctx, "learn")
    if not r or not u:
        return None
    scale = ctx["config"]["num_steps_per_env"] / ctx["profiled"]["rollout"]
    busy = scale * sum(s["busy_s"] for s in r) + sum(s["busy_s"] for s in u)
    wall = scale * sum(s["wall_s"] for s in r) + sum(s["wall_s"] for s in u)
    return share(100.0 * (1.0 - busy / wall), "device_idle_share")


def idle_share(ctx, label):
    s = slices(ctx, label)
    if not s:
        return None
    busy, wall = sum(x["busy_s"] for x in s), sum(x["wall_s"] for x in s)
    return share(100.0 * (1.0 - busy / wall), "device_idle_share")


def mfu(ctx, flops_per_unit):
    w = ctx["window"]
    return share(100.0 * flops_per_unit * w["units"] / (w["seconds"] * work.H100_FP32_FLOPS), "mfu")
