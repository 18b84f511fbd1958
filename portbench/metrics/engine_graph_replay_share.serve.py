"""Share of the profiled serving steps whose lanes engine replayed a
captured CUDA graph, in %: the program's `engine.graph_replay` spans over
its `env.engine` spans. None where the program captures no graph."""
import importlib.util

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
    if importlib.util.find_spec("pbhc_tpu_torch.sim.step_graph") is None:
        return None
    r = records(ctx, "serve")
    engine = sum(x.name == "env.engine" for x in r or ())
    if not engine:
        return None
    return 100.0 * sum(x.name == "engine.graph_replay" for x in r) / engine
