"""Launches a refit step: every launch inside a ``bark.step`` span of the capture with
the host's operations, its children's included (``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.launches_in_steps(ctx)
