"""K1's (ops/gram) share of its roofline in the profiled BO iteration, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "k1")
