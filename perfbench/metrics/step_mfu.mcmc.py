"""The algorithm's floating-point work of a chain-step (roofline/counts.step_flops) at the
window's rate, against float32 peak, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.mfu(ctx.get("flops_per_step", 0) * ctx.get("steps_per_s", 0), 1.0)
