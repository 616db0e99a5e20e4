"""K1's (ops/gram) share of its roofline in the profiled sampler call, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "k1")
