"""The share of the window's asks whose first point repeated a training row or the
previous proposal, so that the ask paid for the Thompson retry (the strategy's
``duplicate_asks``), in %; None on a program without the counter."""


def read(ctx):
    duplicates, asks = ctx.get("duplicate_asks"), ctx.get("asks")
    if duplicates is None or not asks:
        return None
    return 100.0 * duplicates / asks
