"""Launches a step of the move scan's kernel K3 (device events named ``move_scan_kernel``)
in the profiled sampler call: 1.0 where the dense scan runs as one kernel, 0.0 where it
runs as a torch loop."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("profiled_steps"):
        return None
    return len(trace.named(("move_scan_kernel",))) / ctx["profiled_steps"]
