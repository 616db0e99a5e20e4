"""The inclusive time in ms of the duplicate retry (the spans ``bark.ask.dedup``: the
Thompson build and search, the random last resort) an ask, in the capture with the host's
operations (longer than untraced; ``lib/spans.py``): 0.0 where the captured ask took no
retry, None where the capture holds no ask."""

from perfbench.lib import spans

SPAN = "bark.ask.dedup"


def read(ctx):
    found = spans.of(ctx)
    asks = found.count("bark.ask") if found is not None else 0
    if not asks:
        return None
    return sum(e.dur_ns for e in found.spans if e.name == SPAN) / 1e6 / asks
