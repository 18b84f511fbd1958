"""Synchronising CUDA operations per profiled serving step, counted by the
program in its `policy` and `env.step` spans and the spans inside them."""
from pbhc_tpu_torch.utils import profiling


def records(ctx, label):
    """The program's span records of this run's profiled slice `label` (the
    last sessions of records, one a slice, in order); None where the program
    records no spans."""
    if not hasattr(profiling, "sessions") or not ctx["slices"]:
        return None
    runs = profiling.sessions()[-len(ctx["slices"]):]
    for s, recs in zip(ctx["slices"], runs):
        if s["label"] == label:
            return recs
    return None


def read(ctx):
    r = records(ctx, "serve")
    steps = sum(x.name == "env.step" for x in r or ())
    if not steps:
        return None
    return sum(x.syncs for i, x in enumerate(r) if profiling.root_of(r, i) in ("policy", "env.step")) / steps
