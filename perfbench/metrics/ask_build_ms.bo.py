"""The self time in ms of the acquisition build (the span ``bark.ask.build``) an ask, in
the capture with the host's operations (longer than untraced; ``lib/spans.py``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.self_ms_per_ask(ctx, "bark.ask.build")
