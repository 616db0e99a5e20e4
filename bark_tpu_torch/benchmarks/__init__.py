"""Benchmark objectives of the port, by registry name.

Counterpart of ``bark_tpu/benchmarks/__init__.py``: importing this package
registers every ported benchmark with :func:`map_benchmark`. The reference's
names that wait for a later slice (``base.NOT_PORTED``) raise
``NotImplementedError``.
"""

from bark_tpu_torch.benchmarks.base import BENCHMARK_MAP, Benchmark, map_benchmark

# importing registers each benchmark
from bark_tpu_torch.benchmarks import constrained as _constrained  # noqa: F401
from bark_tpu_torch.benchmarks import hartmann as _hartmann  # noqa: F401
from bark_tpu_torch.benchmarks import mixed as _mixed  # noqa: F401
from bark_tpu_torch.benchmarks import multi_fidelity as _multi_fidelity  # noqa: F401
from bark_tpu_torch.benchmarks import pest as _pest  # noqa: F401
from bark_tpu_torch.benchmarks import tree_function as _tree_function  # noqa: F401
from bark_tpu_torch.benchmarks import unconstrained as _unconstrained  # noqa: F401

__all__ = ["BENCHMARK_MAP", "Benchmark", "map_benchmark"]
