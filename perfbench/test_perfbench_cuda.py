"""The harness on the card: one short run of each cell, plain and traced,
with ``correct`` true. Marked ``cuda``; each test decides inside itself
whether there is a card and skips without one. On the card:

    python -m pytest perfbench -q -o addopts="" -p no:cacheprovider -m cuda
"""

from __future__ import annotations

import pytest
import torch

from perfbench import run as bench_run

CELLS = ["mcmc.treefn5.n50", "bo.treefn5.n50"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code, result = bench_run.run(["--workload", cell, "--seed", str(2**40 + 3), "--seconds",
                                  "3", "--trace", str(trace)])
    assert code == 0
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0 and result["metrics"]
