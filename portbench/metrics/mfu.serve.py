"""The whole serving step's share of the float32 peak: the counted work of
the window's control steps (the actor's forward, the contact solves) over the
window's seconds x 67 TFLOP/s."""
from portbench.counts import work
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, work.serve_step_flops(ctx["config"]))
