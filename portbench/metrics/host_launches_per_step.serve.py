"""Host calls of the CUDA runtime that launch work (kernels and graphs) per
control step, over the profiled serving steps: a count."""
from portbench.readers import slices


def read(ctx):
    s = slices(ctx, "serve")
    return sum(x["launches"] for x in s) / ctx["profiled"]["serve"] if s else None
