"""Benchmark objectives of the port, by registry name.

Counterpart of ``bark_tpu/benchmarks/__init__.py``: importing this package
registers every benchmark of the reference's registry with
:func:`map_benchmark`.
"""

from bark_tpu_torch.benchmarks.base import BENCHMARK_MAP, Benchmark, map_benchmark

# importing registers each benchmark
from bark_tpu_torch.benchmarks import cco as _cco  # noqa: F401
from bark_tpu_torch.benchmarks import constrained as _constrained  # noqa: F401
from bark_tpu_torch.benchmarks import dataset as _dataset  # noqa: F401
from bark_tpu_torch.benchmarks import hartmann as _hartmann  # noqa: F401
from bark_tpu_torch.benchmarks import hpo as _hpo  # noqa: F401
from bark_tpu_torch.benchmarks import max_bandit as _max_bandit  # noqa: F401
from bark_tpu_torch.benchmarks import mixed as _mixed  # noqa: F401
from bark_tpu_torch.benchmarks import multi_fidelity as _multi_fidelity  # noqa: F401
from bark_tpu_torch.benchmarks import pest as _pest  # noqa: F401
from bark_tpu_torch.benchmarks import reaction_emulator as _reaction  # noqa: F401
from bark_tpu_torch.benchmarks import svr_bench as _svr_bench  # noqa: F401
from bark_tpu_torch.benchmarks import tree_function as _tree_function  # noqa: F401
from bark_tpu_torch.benchmarks import unconstrained as _unconstrained  # noqa: F401

__all__ = ["BENCHMARK_MAP", "Benchmark", "map_benchmark"]
