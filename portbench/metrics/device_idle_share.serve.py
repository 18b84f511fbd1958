"""The device's idle share of serving: 1 - the union of kernel intervals over
the wall time of the profiled control steps."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "serve")
