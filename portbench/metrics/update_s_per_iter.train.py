"""Seconds per iteration in the update phase: span around `algo.learn`
(GAE, the minibatch epochs, Adam)."""
from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "learn")
