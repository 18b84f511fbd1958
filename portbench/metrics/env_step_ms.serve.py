"""Milliseconds per control step in the env step: span around `env.step`,
the window's sum over its count."""
from portbench.readers import span_mean


def read(ctx):
    s = span_mean(ctx, "env.step")
    return None if s is None else 1e3 * s
