"""The port's entry-point drivers at tiny sizes on the CPU.

Each driver of ``bark_tpu_torch/benchmarks`` that twins a script of
``examples/`` or ``tools/`` runs with ``device="cpu"`` and writes under
``tmp_path``; its outputs are held to the reference's: the same JSON keys,
CSV columns and ``.npy`` names and shapes, the assertions of the reference's
own tests of those scripts, and the reference's numpy code on the same
arrays (summaries equal to 1e-12). The sharded PT/SMC run over two Gloo
ranks equals its single-process counterparts (PT exactly, SMC to 1e-5, as
``tests/test_torch_distributed.py`` holds them). Without ``--device`` every
driver refuses to run on a machine with no CUDA device.
"""

import importlib
import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from torch_support import REPO

from bark_tpu.utils.diagnostics import mll_trace_summary as ref_mll_trace_summary

from bark_tpu_torch.benchmarks import (
    bandit_bo,
    bo_largen,
    largen_timing,
    mcmc_record,
    plot_bo_runs,
    priors_and_proposals,
    regression_hpo,
    samples_ablation,
    scaling,
    tempered_smc,
)
from bark_tpu_torch.benchmarks.study import EXAMPLE_CONFIGS


def keys_of(tree):
    """The nested key structure of a JSON payload (lists by their first item)."""
    if isinstance(tree, dict):
        return {k: keys_of(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [keys_of(tree[0])]
    return None


def load_example(name):
    spec = importlib.util.spec_from_file_location(f"{name}_example",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bo_largen_loop_and_record_keys():
    """The assertions of tests/optimization/test_bo_largen.py, and the keys
    of results/bo_largen/study_n4080_seed0.json."""
    res = bo_largen.run_study(seed=0, n_init=120, num_iter=2, num_candidates=256,
                              num_chains=2, num_samples=3, acq_backend="lowrank",
                              device="cpu")
    its = res["iterations"]
    assert len(its) == 2
    assert its[0]["n_train"] == 121 and its[1]["n_train"] == 122
    bests = [r["best_y"] for r in its]
    assert all(np.isfinite(b) for b in bests)
    assert bests[1] <= bests[0] + 1e-12
    assert all(r["fit_s"] >= 0 and r["ask_s"] > 0 for r in its)
    ref = json.loads((REPO / "results" / "bo_largen" / "study_n4080_seed0.json").read_text())
    assert keys_of(json.loads(json.dumps(res))) == keys_of(ref)


def test_largen_timing_records_have_the_reference_keys(tmp_path):
    ref_ask = json.loads((REPO / "results" / "acq_lr" / "ask_latency.json").read_text())
    ref_predict = json.loads((REPO / "results" / "acq_lr" / "predict_latency.json").read_text())
    rec = largen_timing.time_ask(300, "lowrank", num_samples=2, device="cpu")
    assert keys_of(rec) == keys_of(ref_ask["records"][0])
    assert rec["in_domain"] and np.isfinite(rec["acq_value"])
    out = largen_timing.main(["--predict-only", "--ns", "2048", "--out-dir", str(tmp_path),
                              "--device", "cpu"])
    rows = json.loads((tmp_path / "predict_latency.json").read_text())
    assert rows == out["predict"]
    assert [(r["n"], r["backend"]) for r in rows] == [(2048, b) for b in ("dense", "cg", "leaf")]
    assert keys_of(rows) == keys_of(ref_predict)


def test_mcmc_record_traces_and_summary(tmp_path):
    """The MCMC config pair at 40 samples, the model config from a YAML file."""
    import yaml

    assert EXAMPLE_CONFIGS["mcmc_model"]["model_params"]["num_chains"] == 4
    model = {"model": "BARK", "model_params": {
        **EXAMPLE_CONFIGS["mcmc_model"]["model_params"], "num_samples": 40}}
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(model))
    summary = mcmc_record.main(["-s", "0", "-m", str(tmp_path / "model.yaml"),
                                "-o", str(tmp_path), "--device", "cpu"])
    mlls = np.load(tmp_path / "mlls.npy")
    noise = np.load(tmp_path / "noise_samples.npy")
    assert mlls.shape == noise.shape == (4, 40)
    assert np.isfinite(mlls).all() and (noise > 0).all()
    ref = ref_mll_trace_summary(mlls)
    assert summary.keys() == ref.keys()
    np.testing.assert_allclose([summary[k] for k in ref], [ref[k] for k in ref],
                               rtol=1e-12, atol=0)


def test_tempered_smc_sharded_equals_the_single_process_runs(tmp_path):
    kw = dict(num_steps=6, num_particles=8)
    got = tempered_smc.run_sharded(3, 2, device="cpu", **kw)
    want = tempered_smc.sharded_twin(3, 2, device="cpu", **kw)
    # rank 0's PT trace is the single-process cold chain's, bit for bit
    traces, rank0 = want.pop("traces"), got.pop("ranks")[0]
    for k in ("swap_rate", "mll", "noise"):
        assert torch.equal(rank0[k], traces[k]), k
    assert got.keys() == want.keys() and got["pt"].keys() == want["pt"].keys()
    for k, v in want["pt"].items():
        np.testing.assert_allclose(got["pt"][k], v, rtol=1e-12, atol=0, err_msg=k)
    for k, v in want["smc"].items():
        np.testing.assert_allclose(got["smc"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    out = tmp_path / "single.json"
    single = tempered_smc.main(["-s", "3", "--num-replicas", "4", "--num-steps", "6",
                                "--num-particles", "8", "-o", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == single
    assert single.keys() == got.keys() and single["pt"].keys() == got["pt"].keys()
    assert single["pt"]["replicas"] == 4 and 0.0 <= single["pt"]["swap_rate"] <= 1.0
    # the sharded SMC draws what run_smc draws from the same generator
    for k, v in single["smc"].items():
        np.testing.assert_allclose(got["smc"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["smc"]["final_beta"] == 1.0


def test_bandit_hpo_and_ablation_write_the_reference_files(tmp_path):
    rows = bandit_bo.main(["-s", "0", "-n", "2", "-o", str(tmp_path), "--device", "cpu"])
    text = (tmp_path / "bandit_seed=0.csv").read_text().splitlines()
    # examples/bandit_bo.py's columns
    assert text[0] == "iteration,picked,y,best,regret" and len(text) == 3
    assert [r["best"] for r in rows] == sorted((r["best"] for r in rows), reverse=True)
    assert len({r["picked"] for r in rows}) == 2

    bench = {**EXAMPLE_CONFIGS["regression_treefunction"], "num_train": 30, "num_test": 40}
    grid = regression_hpo.run_hpo(0, bench, [0.5, 0.95], [1.0, 2.0], tmp_path,
                                  model_params={"warmup_steps": 10, "num_samples": 3},
                                  device="cpu")
    saved = np.load(tmp_path / "nlpd_hpo_TreeFunction_seed=0.npy")
    assert saved.shape == (2, 2) and np.array_equal(saved, grid) and np.isfinite(grid).all()
    grid = samples_ablation.run_ablation(0, bench, tmp_path, [1, 2], [2, 3], 1, device="cpu")
    saved = np.load(tmp_path / "nlpd_ablation_TreeFunction_seed=0.npy")
    assert saved.shape == (2, 2) and np.array_equal(saved, grid) and np.isfinite(grid).all()


def test_scaling_payload_has_the_reference_keys(tmp_path):
    ref = json.loads((REPO / "SCALING_r05.json").read_text())
    out = tmp_path / "scaling.json"
    payload = scaling.main(["--ranks", "1", "2", "--chains-per-rank", "2",
                            "--total-chains", "4", "--num-steps", "2", "--out", str(out),
                            "--device", "cpu"])
    assert json.loads(out.read_text()) == payload
    got, want = keys_of(payload), keys_of(ref)
    assert {k: got[k] for k in want} == want
    assert payload["dry_run"] and payload["ranks"] == [1, 2]
    weak = payload["weak_scaling"]["results"]
    assert [r["chains"] for r in weak] == [2, 4] and weak[0]["efficiency"] == 1.0
    assert all(r["steps_per_s"] > 0 for r in payload["sharding_overhead"]["results"])


def test_priors_and_proposals_summary(tmp_path):
    """The assertions of tests/test_diagnostics_drivers.py on the priors
    study, at the script's default size (4000 steps x 64 chains): the noise
    prior InvGamma(1.5, 1/5) has no variance, so the correct chain's
    z-score stays of order 1-10 at any length, while the reference ratio's
    bias grows it with the chain."""
    out = tmp_path / "study.json"
    summary = priors_and_proposals.main(["--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == summary
    ref = json.loads((REPO / "results" / "diagnostics" / "priors_and_proposals.json")
                     .read_text())
    assert keys_of(summary) == keys_of(ref)
    assert abs(summary["proposal_lognormal"]["proposal_log_std"] - 1.0) < 0.1
    z_correct = summary["default_correct_ratio"]["noise_prior_mean_z"]
    z_reference = summary["reference_ratio_for_contrast"]["noise_prior_mean_z"]
    assert z_reference > 5 * max(z_correct, 1.0)
    q90_an = summary["noise_prior_quantiles_analytic"][2]
    q90_ref = summary["reference_ratio_for_contrast"]["noise_prior_quantiles_empirical"][2]
    assert q90_ref < 0.7 * q90_an
    # the quantiles of the correct chain sit on the analytic prior's
    np.testing.assert_allclose(summary["default_correct_ratio"]
                               ["noise_prior_quantiles_empirical"],
                               summary["noise_prior_quantiles_analytic"], rtol=0.05)
    assert {p.name for p in tmp_path.glob("*.png")} == {
        "proposal_lognormal.png", "prior_densities.png", "noise_mh_vs_prior.png"}


def test_plot_bo_runs_summary_equals_the_reference(tmp_path, monkeypatch):
    runs_dir = REPO / "results" / "regret_r2"
    ref = load_example("plot_bo_runs")
    want = {}
    for (bench, strategy), traces in sorted(ref.load_runs(runs_dir).items()):
        mean, std = ref.aggregate(traces)
        want[f"{bench}/{strategy}"] = (len(traces), len(mean), mean[-1], std[-1])
    summary = plot_bo_runs.main([str(runs_dir), "--out", str(tmp_path / "runs.png")])
    assert (tmp_path / "runs.png").exists()
    assert json.loads((tmp_path / "runs.json").read_text()) == summary
    assert summary.keys() == want.keys()
    for key, (seeds, iters, mean, std) in want.items():
        got = summary[key]
        assert (got["seeds"], got["iterations"]) == (seeds, iters)
        np.testing.assert_allclose([got["final_best_mean"], got["final_best_std"]],
                                   [mean, std], rtol=1e-12, atol=1e-12)
    # the assertions of tests/test_diagnostics_drivers.py on the same summary
    assert summary["PestControl/BARK"]["seeds"] == 5
    assert (summary["TreeFunction/BARK"]["final_best_mean"]
            < summary["TreeFunction/Random"]["final_best_mean"])
    # without matplotlib the summary is still written, and the figure
    # raises naming it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        plot_bo_runs.main([str(runs_dir), "--out", str(tmp_path / "none" / "runs.png")])
    assert (tmp_path / "none" / "runs.json").exists()
    assert plot_bo_runs.main([str(runs_dir), "--no-plots", "--summary-out",
                              str(tmp_path / "s.json")]) == summary


@pytest.mark.parametrize("name,argv", [
    ("bo_largen", ["--out", "unused.json"]),
    ("largen_timing", ["--out-dir", "unused"]),
    ("mcmc_record", ["-o", "unused"]),
    ("tempered_smc", ["-o", "unused.json"]),
    ("bandit_bo", ["-o", "unused"]),
    ("regression_hpo", ["-o", "unused"]),
    ("samples_ablation", ["-o", "unused"]),
    ("scaling", ["--out", "unused.json"]),
    ("priors_and_proposals", ["--out", "unused.json"]),
])
def test_drivers_run_on_the_card_unless_asked_for_the_cpu(name, argv, monkeypatch, tmp_path):
    module = importlib.import_module(f"bark_tpu_torch.benchmarks.{name}")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not any(tmp_path.iterdir())


def test_drivers_import_neither_jax_nor_the_reference():
    for name in ("bo_largen", "largen_timing", "mcmc_record", "tempered_smc", "bandit_bo",
                 "regression_hpo", "samples_ablation", "scaling", "priors_and_proposals",
                 "plot_bo_runs"):
        source = (REPO / "bark_tpu_torch" / "benchmarks" / f"{name}.py").read_text()
        assert "import jax" not in source and "bark_tpu." not in source, name
        importlib.import_module(f"bark_tpu_torch.benchmarks.{name}")
