"""Launches a step inside the refresh (the span ``bark.step.refresh``: the noise move and
the new state), from the capture with the host's operations (``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_step(ctx, "launches", "bark.step.refresh")
