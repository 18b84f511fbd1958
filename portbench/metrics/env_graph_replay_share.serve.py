"""Share of the env stages of the profiled serving steps that replayed a
captured CUDA graph, in %: the program's `env.graph_replay` spans over its
`env.actions`, `env.rewards`, `env.resets` and `env.observations` spans.
None where the program captures no stage graph."""
import importlib
import importlib.util

from pbhc_tpu_torch.utils import profiling

STAGES = ("env.actions", "env.rewards", "env.resets", "env.observations")


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


def captures_stages() -> bool:
    """Whether the program replays its env stages as graphs at all."""
    spec = importlib.util.find_spec("pbhc_tpu_torch.sim.step_graph")
    return spec is not None and hasattr(importlib.import_module(spec.name), "StageGraphs")


def read(ctx):
    if not captures_stages():
        return None
    r = records(ctx, "serve")
    stages = sum(x.name in STAGES for x in r or ())
    if not stages:
        return None
    return 100.0 * sum(x.name == "env.graph_replay" for x in r) / stages
