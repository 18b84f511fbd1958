"""Host milliseconds per control step in the program's `teacher` span of a
distillation rollout (the frozen teacher's action, inside `policy`), over
the `env.step` spans of the profiled rollout slice (host time under the
profiler). None where the program records no such span."""
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
    t = stages(ctx, "rollout")
    if not t or "env.step" not in t or "teacher" not in t:
        return None
    return 1e3 * t["teacher"]["seconds"] / t["env.step"]["count"]
