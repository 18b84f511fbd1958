"""Synchronising CUDA operations per training iteration, counted by the
program in its spans: the profiled rollout steps' count per step times the
rollout's steps, plus the profiled update's count."""
from pbhc_tpu_torch.utils import profiling


def stages(ctx, label):
    """{span: {"count", "seconds", "syncs"}} of the program's spans in this
    run's profiled slice `label` (the last sessions of records, one a slice,
    in order); None where the program records no spans."""
    if not hasattr(profiling, "sessions") or not ctx["slices"]:
        return None
    runs = profiling.sessions()[-len(ctx["slices"]):]
    for s, records in zip(ctx["slices"], runs):
        if s["label"] == label:
            return profiling.totals(records)
    return None


def read(ctx):
    r, u = stages(ctx, "rollout"), stages(ctx, "learn")
    if not r or "env.step" not in r or not u:
        return None
    per_step = sum(t["syncs"] for t in r.values()) / r["env.step"]["count"]
    return per_step * ctx["config"]["num_steps_per_env"] + sum(t["syncs"] for t in u.values())
