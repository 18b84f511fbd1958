"""Milliseconds per control step in the networks: span around
`batch_eval.act_mean`."""
from portbench.readers import span_mean


def read(ctx):
    s = span_mean(ctx, "act_mean")
    return None if s is None else 1e3 * s
