"""The self time in ms of the search, K1 scoring included (the span ``bark.ask.search``), an
ask, in the capture with the host's operations (longer than untraced; ``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.self_ms_per_ask(ctx, "bark.ask.search")
