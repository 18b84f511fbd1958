"""Seconds per iteration in the rollout phase: span around `algo.rollout`."""
from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "rollout")
