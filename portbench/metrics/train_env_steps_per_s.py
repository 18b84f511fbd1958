"""Training throughput: env-steps of the window's whole iterations over the
host seconds they took (the last synchronised)."""


def read(ctx):
    w = ctx["window"]
    return w["env_steps"] / w["seconds"]
