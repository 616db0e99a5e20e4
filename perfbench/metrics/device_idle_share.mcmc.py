"""The share of the profiled sampler call in which no operation ran on the device, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
