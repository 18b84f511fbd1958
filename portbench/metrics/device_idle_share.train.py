"""The device's idle share of a training iteration: 1 - the union of kernel
intervals over the wall time, from the profiled rollout steps (scaled to the
rollout's length) and the profiled update."""
from portbench.readers import idle_share_train


def read(ctx):
    return idle_share_train(ctx)
