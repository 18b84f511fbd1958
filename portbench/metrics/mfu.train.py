"""The whole training step's share of the float32 peak: the counted work of
the window's iterations (networks forward, forward and backward, the contact
solves) over the window's seconds x 67 TFLOP/s."""
from portbench.counts import work
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, work.train_iteration_flops(ctx["config"]))
