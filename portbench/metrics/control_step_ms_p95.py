"""The 95th percentile of every control step of the window, each timed
between the CUDA events recorded after it and after the step before."""
from portbench.readers import p95


def read(ctx):
    return 1e3 * p95(ctx["window"]["unit_s"])
