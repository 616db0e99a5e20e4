"""Seconds a window iteration spends in ``ask`` (acquisition build, scoring, search and
centring): the harness's span around the call, closed by a synchronisation."""

from perfbench.lib import readers


def read(ctx):
    return readers.span_mean(ctx, "ask_s")
