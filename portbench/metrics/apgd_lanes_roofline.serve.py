"""Kernel 1's share of its roofline in serving: the least time its bytes
take at the HBM peak over its device time per launch, in the profiled
control steps."""
from portbench.readers import apgd_lanes_roofline


def read(ctx):
    return apgd_lanes_roofline(ctx, ("serve",))
