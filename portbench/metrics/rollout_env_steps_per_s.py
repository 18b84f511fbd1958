"""Serving throughput: envs x control steps of the window over its host
seconds (the last synchronised)."""


def read(ctx):
    w = ctx["window"]
    return w["env_steps"] / w["seconds"]
