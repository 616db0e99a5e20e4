"""The host's synchronising calls a step inside the proposal batch (the span
``bark.step.propose``), from the capture with the host's operations (``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_step(ctx, "syncs", "bark.step.propose")
