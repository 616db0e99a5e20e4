"""Launches a step inside the move scan (the span ``bark.step.scan``: the update patterns,
the m moves, the merge), from the capture with the host's operations (``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_step(ctx, "launches", "bark.step.scan")
