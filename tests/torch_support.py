"""What every test process of the PyTorch port shares.

Importing this module caps torch's intra-op threads under pytest-xdist:
each worker gets the machine's cores divided by the number of workers
(at least one), so the workers do not oversubscribe the cores between
them. ``OMP_NUM_THREADS`` is set to the same cap unless it is already set,
so every process a test starts afterwards (a JAX reference run, a ``-c``
check, a spawned rank) inherits it. Outside xdist it changes nothing.
The port's test files that need the checkout's path, a reference run or a
``-c`` check import from here, and an xdist worker imports every test
module while it collects, so the cap is in place in every worker before
any test runs.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _cap = max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    torch.set_num_threads(_cap)
    os.environ.setdefault("OMP_NUM_THREADS", str(_cap))


def run_reference(script, out_dir, name: str, timeout: float = 600) -> dict:
    """Run ``script`` as ``python script OUT`` with the JAX reference on the
    CPU and x64 off (the suite's conftest turns it on), and return the
    arrays it saved to ``out_dir/name``."""
    out = Path(out_dir) / name
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_ENABLE_X64", None)
    proc = subprocess.run(
        [sys.executable, str(Path(script).resolve()), str(out)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def run_python(code: str, timeout: float) -> subprocess.CompletedProcess:
    """Run ``python -c code`` in the checkout, capturing its output as text."""
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=timeout,
    )
