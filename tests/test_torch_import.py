"""The PyTorch port stands without JAX, and its chip check needs a card.

The machine with the GPU has no JAX, so every module of ``bark_tpu_torch``
and ``chip_smoke.py`` must import with ``jax`` unavailable. These run in
subprocesses so the suite's own JAX import cannot mask a stray one.
"""

import subprocess
import sys

import pytest

from torch_support import REPO, run_python

PORT = REPO / "bark_tpu_torch"


def test_port_imports_without_jax():
    proc = run_python(
        "import sys; sys.modules['jax'] = None\n"
        "import bark_tpu_torch.fitting.sampler, bark_tpu_torch.benchmarks.tree_function\n"
        "import bark_tpu_torch.convert, bark_tpu_torch.domain, bark_tpu_torch.ops.linalg\n"
        "import bark_tpu_torch.ops._build\n"
        "import bark_tpu_torch.constraints, bark_tpu_torch.benchmarks\n"
        "import bark_tpu_torch.models.gp, bark_tpu_torch.models.surrogate\n"
        "import bark_tpu_torch.optimizer.acquisition, bark_tpu_torch.optimizer.search\n"
        "import bark_tpu_torch.strategies.capabilities, bark_tpu_torch.strategies.tree_kernel\n"
        "import bark_tpu_torch.utils.diagnostics, bark_tpu_torch.benchmarks.kernel_timing\n"
        "import bark_tpu_torch.fitting.prior, bark_tpu_torch.parallel.tempering\n"
        "import bark_tpu_torch.parallel.smc, bark_tpu_torch.benchmarks.ab_tempered\n"
        "import bark_tpu_torch.models.sampling, bark_tpu_torch.ops.iterative\n"
        "import bark_tpu_torch.benchmarks.stationary\n"
        "import bark_tpu_torch.native, bark_tpu_torch.fitting.booster\n"
        "import bark_tpu_torch.models.leafgp, bark_tpu_torch.models.mogp\n"
        "import bark_tpu_torch.optimizer.fidelity, bark_tpu_torch.strategies.multi_fidelity\n"
        "import bark_tpu_torch.benchmarks.multi_fidelity, bark_tpu_torch.benchmarks.mf_bo\n"
        "import bark_tpu_torch.fitting.bart, bark_tpu_torch.models.bart\n"
        "import bark_tpu_torch.strategies.baselines, bark_tpu_torch.benchmarks.base\n"
        "import bark_tpu_torch.benchmarks.unconstrained, bark_tpu_torch.benchmarks.constrained\n"
        "import bark_tpu_torch.benchmarks.mixed, bark_tpu_torch.benchmarks.pest\n"
        "import bark_tpu_torch.benchmarks.hartmann, bark_tpu_torch.benchmarks.study\n"
        "import bark_tpu_torch.benchmarks.regression\n"
        "import bark_tpu_torch.utils.metrics, bark_tpu_torch.utils.timer\n"
        "import bark_tpu_torch.parallel.distributed, bark_tpu_torch.parallel.sharding\n"
        "import bark_tpu_torch.graft_entry, bark_tpu_torch.utils.checkpoint\n"
        "import bark_tpu_torch.utils.profiling, bark_tpu_torch.utils.plots\n"
        "import bark_tpu_torch.benchmarks.cco, bark_tpu_torch.benchmarks.max_bandit\n"
        "import bark_tpu_torch.benchmarks.reaction_emulator, bark_tpu_torch.benchmarks.svr_bench\n"
        "import bark_tpu_torch.benchmarks.dataset, bark_tpu_torch.benchmarks.hpo\n"
        "assert not any(m == 'bark_tpu' or m.startswith('bark_tpu.') for m in sys.modules)\n"
        "print('ok')\n",
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_new_benchmarks_run_without_jax_sklearn_pandas_or_matplotlib():
    """As on the GPU machine: MAXBandit (its JSON shipped in the package),
    ToyReaction and CCOBench evaluate; SVRBench, XGBoostMNIST and
    DatasetBenchmark raise naming the package they need; the plots raise
    naming matplotlib and format_tree still works."""
    proc = run_python(
        "import sys\n"
        "for m in ('jax', 'sklearn', 'pandas', 'xgboost', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from bark_tpu_torch.benchmarks import map_benchmark\n"
        "for name in ('MAXBandit', 'ToyReaction', 'CCOBench'):\n"
        "    b = map_benchmark(name)\n"
        "    y = b.f(b.domain.sample(4, np.random.default_rng(0)))\n"
        "    assert y.shape == (4,) and np.isfinite(y).all(), name\n"
        "for name, kw, pkg in (('SVRBench', {'num_samples': 400}, 'xgboost'),\n"
        "                      ('SVRBench', {'num_samples': 400, 'backend': 'sklearn'}, 'sklearn'),\n"
        "                      ('XGBoostMNIST', {'backend': 'sklearn'}, 'sklearn'),\n"
        "                      ('DatasetBenchmark', {'dataset_name': 'Abalone'}, 'pandas')):\n"
        "    try:\n"
        "        map_benchmark(name, **kw)\n"
        "    except RuntimeError as e:\n"
        "        assert pkg in str(e), (name, str(e))\n"
        "    else:\n"
        "        raise SystemExit(f'{name} built without {pkg}')\n"
        "from bark_tpu_torch.forest import create_empty_forest\n"
        "from bark_tpu_torch.utils import plots\n"
        "f = create_empty_forest(3, 8)\n"
        "assert plots.format_tree(f, 0) == 'leaf[0]'\n"
        "try:\n"
        "    plots.plot_forest_depths(None, f)\n"
        "except RuntimeError as e:\n"
        "    assert 'matplotlib' in str(e)\n"
        "else:\n"
        "    raise SystemExit('plotted without matplotlib')\n"
        "print('ok')\n",
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_max_bandit_data_ships_with_the_package():
    """The JSON is a byte copy of the reference's and is package data."""
    port = PORT / "benchmarks" / "data" / "MAX_data.json"
    ref = REPO / "bark_tpu" / "benchmarks" / "data" / "MAX_data.json"
    assert port.read_bytes() == ref.read_bytes()
    assert '"benchmarks/data/*.json"' in (REPO / "pyproject.toml").read_text()


def test_no_port_source_imports_jax():
    offenders = []
    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                words[1].split(".")[0] in ("jax", "jaxlib", "bark_tpu")
            ):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not offenders, offenders


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA here: the chip check must exit non-zero and print no result,
    in the checkout and in a directory holding only the script."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        cwd = tmp_path
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_failure_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as an exception carrying its output; no
    library is left behind and nothing falls back."""
    from bark_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_library", None)
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.load_library()
    assert list((tmp_path / "build").iterdir()) == []
    assert _build._library is None


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; the CPU path is the
    dispatch to the plain versions, never a fallback inside a wrapper."""
    import torch

    from bark_tpu_torch.ops.chol import chol_inv_cuda
    from bark_tpu_torch.ops.gram import gram_cuda

    leaves = torch.zeros((1, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda(leaves, leaves)
    with pytest.raises(ValueError, match="CUDA"):
        chol_inv_cuda(torch.eye(4)[None])
    assert gram_cuda.launches == 0 and chol_inv_cuda.launches == 0


def test_bo_script_runs_on_the_port_without_jax():
    """The documented BO flow with only the package name and ``device``
    changed, JAX unavailable: a few iterations on the CPU; without
    ``device`` and without a card it raises."""
    proc = run_python(
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from bark_tpu_torch.benchmarks import map_benchmark\n"
        "from bark_tpu_torch.fitting.params import SamplerParams\n"
        "from bark_tpu_torch.strategies.tree_kernel import make_strategy\n"
        "bench = map_benchmark('TreeFunction', dim=2, m=10, function_seed=1)\n"
        "X = bench.domain.sample(8, np.random.default_rng(0)); y = bench.f(X)\n"
        "params = SamplerParams(warmup_steps=5, num_samples=4, steps_per_sample=2,\n"
        "                       num_chains=2, num_trees=20)\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        make_strategy('BARK', bench.domain, seed=0, params=params)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no device asked for, no card, and no error')\n"
        "s = make_strategy('BARK', bench.domain, seed=0, params=params,\n"
        "                  num_candidates=256, num_rounds=2, device='cpu')\n"
        "s.tell(X, y)\n"
        "for i in range(3):\n"
        "    c = s.ask(1); s.add(c, bench.f(c))\n"
        "assert len(s.y) == 11 and s.fallbacks == 0 and np.isfinite(s.y).all()\n"
        "assert not any(m == 'bark_tpu' or m.startswith('bark_tpu.') for m in sys.modules)\n"
        "print('ok')\n",
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_booster_surrogates_run_on_the_port_without_jax():
    """LeafGP's BO loop and one iteration of the multi-fidelity study on the
    CPU with JAX unavailable; without ``device`` and without a card the
    study raises."""
    proc = run_python(
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from bark_tpu_torch.benchmarks import map_benchmark\n"
        "from bark_tpu_torch.benchmarks.mf_bo import run_study\n"
        "from bark_tpu_torch.strategies.tree_kernel import make_strategy\n"
        "bench = map_benchmark('TreeFunction', dim=2, m=10, function_seed=1)\n"
        "X = bench.domain.sample(10, np.random.default_rng(0))\n"
        "s = make_strategy('LeafGP', bench.domain, num_candidates=128, num_rounds=1,\n"
        "                  num_boost_round=8, device='cpu')\n"
        "s.tell(X, bench.f(X))\n"
        "for i in range(2):\n"
        "    c = s.ask(); s.add(c, bench.f(c))\n"
        "rec = run_study(0, 1, num_candidates=32, num_fstar=4,\n"
        "                surrogate_kwargs={'num_boost_round': 8}, device='cpu')\n"
        "assert len(s.y) == 12 and s.fallbacks == 0 and rec[0]['fidelity'] in (0, 1)\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        run_study(0, 1)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no device asked for, no card, and no error')\n"
        "assert not any(m == 'bark_tpu' or m.startswith('bark_tpu.') for m in sys.modules)\n"
        "print('ok')\n",
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_study_runs_on_the_port_without_jax():
    """The BO-study and regression runners on the CPU with JAX (and PyYAML)
    unavailable, at a tiny size; without ``device`` and without a card the
    study raises."""
    proc = run_python(
        "import sys, tempfile; sys.modules['jax'] = None; sys.modules['yaml'] = None\n"
        "import torch\n"
        "from bark_tpu_torch.benchmarks.study import run_study\n"
        "from bark_tpu_torch.benchmarks.regression import run_regression\n"
        "out = tempfile.mkdtemp()\n"
        "bench = {'benchmark': 'TreeFunction', 'benchmark_params': {'dim': 2, 'm': 10},\n"
        "         'num_init': 5, 'num_iter': 2, 'num_train': 20, 'num_test': 20, 'num_runs': 1}\n"
        "model = {'model': 'BART', 'model_params': {'warmup_steps': 10, 'num_samples': 4,\n"
        "                                           'num_trees': 6}}\n"
        "merged = run_study(0, bench, model, out, device='cpu')\n"
        "run_regression(0, bench, model, out, device='cpu')\n"
        "assert merged['feasible_proposal_rate'] == 1.0\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        run_study(0, bench, model, out)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('no device asked for, no card, and no error')\n"
        "assert not any(m == 'bark_tpu' or m.startswith('bark_tpu.') for m in sys.modules)\n"
        "print('ok')\n",
        timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
