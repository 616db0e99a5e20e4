"""The harness's shared parts: finding cells by name, seeds, traces, readers."""
