"""Share of the minibatch steps of the profiled update of a training
iteration that replayed a captured CUDA graph, in %: the program's
`learner.graph_replay` spans over its `learner.minibatch` spans in the
profiled `learn` slice. None where the program records no
`learner.minibatch` there."""
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
    u = stages(ctx, "learn")
    if not u or "learner.minibatch" not in u:
        return None
    return 100.0 * u.get("learner.graph_replay", {"count": 0})["count"] / u["learner.minibatch"]["count"]
