"""Kernel 3's share of the lanes substeps in serving: launches of the kernel
whose short name holds `lanes_dynamics`, over decimation x the profiled
control steps, in %. 100 where every substep's dynamics ran in the kernel;
nothing to read where no such kernel ran."""
from portbench.readers import slices
from portbench.trace import short_name


def read(ctx):
    n = sum(k["count"] for s in slices(ctx, "serve") for name, k in s["kernels"].items()
            if "lanes_dynamics" in short_name(name))
    if not n:
        return None
    return 100.0 * n / (ctx["config"]["decimation"] * ctx["profiled"]["serve"])
