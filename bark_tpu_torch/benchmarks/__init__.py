"""Benchmark objectives of the port, by registry name.

Counterpart of ``bark_tpu/benchmarks/__init__.py`` with the one benchmark
ported so far: ``map_benchmark("TreeFunction", ...)``.
"""

from bark_tpu_torch.benchmarks.tree_function import TreeFunction

BENCHMARK_MAP: dict[str, type] = {"TreeFunction": TreeFunction}


def map_benchmark(name: str, **kwargs):
    """Instantiate a registered benchmark by name."""
    if name not in BENCHMARK_MAP:
        raise NotImplementedError(
            f"benchmark {name!r} is not ported yet (ROADMAP.md queue 1 item 10); "
            f"the port has {sorted(BENCHMARK_MAP)}"
        )
    return BENCHMARK_MAP[name](**kwargs)


__all__ = ["BENCHMARK_MAP", "map_benchmark"]
