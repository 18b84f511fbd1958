"""Seconds from the process's start to the window's first step: imports,
env and learner build, kernel build or load, checkpoint, warm-up."""


def read(ctx):
    return ctx["setup_s"]
