"""The algorithm's floating-point work of a BO iteration (the refit's chain-steps, the
acquisition's build and scoring) over bo_iter_s, against float32 peak, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.mfu(ctx.get("flops_per_iteration"), ctx.get("bo_iter_s"))
