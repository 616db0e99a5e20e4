"""K2's (ops/chol) share of its roofline in the profiled sampler call, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "k2")
