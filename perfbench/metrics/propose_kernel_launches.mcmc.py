"""Launches a step of the proposal batch's kernel K4 (device events named ``propose_kernel``)
in the profiled sampler call: 1.0 where the batch runs as one kernel, 0.0 where it runs as
torch operations."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("profiled_steps"):
        return None
    return len(trace.named(("propose_kernel",))) / ctx["profiled_steps"]
