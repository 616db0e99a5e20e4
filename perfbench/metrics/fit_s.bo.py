"""Seconds a window iteration spends in ``add`` (the refit through models/surrogate and
fitting/sampler): the harness's span around the call, closed by a synchronisation."""

from perfbench.lib import readers


def read(ctx):
    return readers.span_mean(ctx, "fit_s")
