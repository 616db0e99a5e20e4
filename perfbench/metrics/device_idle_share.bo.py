"""The share of the profiled BO iteration in which no operation ran on the device, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
