"""The host's synchronisations with the device a step, from CUDA's sync debug mode
over a whole call."""


def read(ctx):
    return ctx.get("host_syncs_per_step")
