"""Device kernels a sampler step launches: the profiled call's kernels over its steps."""

from perfbench.lib import readers


def read(ctx):
    return readers.launches_per_step(ctx)
