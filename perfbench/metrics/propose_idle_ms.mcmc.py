"""The device's idle ms a step while the host is in the proposal batch (the span
``bark.step.propose``, innermost at an idle stretch's midpoint; ``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, "bark.step.propose")
