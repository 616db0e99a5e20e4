"""The port's twin of ``bench.py`` against the root ``bench.py``, on the CPU.

The twin's modes run the reference's configurations in the reference's
order and print the same payload (both ``measure`` functions replaced by
recorders); its data, bounds, feature types and ``SamplerParams`` equal
those ``bench.py:50-67`` builds with ``bark_tpu`` (X exact, y_std to
1e-12); a tiny run follows the reference's protocol (two untimed calls,
then the timed ones from the first call's last sample, seeds 0, 1, 2 + i)
in both tiers and returns the reference's seven keys; without a CUDA device
it raises rather than run on the CPU. ``bench_turns`` alternates its two
trees and summarises the runs per point.
"""

import ast
import dataclasses
import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from torch_support import REPO

from bark_tpu.benchmarks.tree_function import TreeFunction as RefTreeFunction
from bark_tpu.fitting.params import SamplerParams as RefSamplerParams

from bark_tpu_torch.benchmarks import bench, bench_turns
from bark_tpu_torch.fitting.sampler import run_bark_sampler


def load_reference_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fake_measure(calls):
    def measure(**kwargs):
        kwargs.pop("device", None)
        calls.append(kwargs)
        return {"metric": "forest_mcmc_steps_per_s_per_chip", "value": 1234.5,
                "unit": "steps/s/chip", "vs_baseline": 1.234, "n_train": kwargs["n_train"],
                "cat_dim": kwargs.get("cat_dim", 0), "num_chains": 64}
    return measure


@pytest.mark.parametrize("argv", [[], ["--curve"], ["--curve-xl"], ["--curve", "--out"],
                                  ["--out"]])
def test_modes_run_the_reference_configurations_in_order(argv, monkeypatch, capsys, tmp_path):
    ref = load_reference_bench()
    ref_calls, twin_calls = [], []
    monkeypatch.setattr(ref, "measure", fake_measure(ref_calls))
    monkeypatch.setattr(bench, "measure", fake_measure(twin_calls))
    outs = {}
    for side in ("ref", "twin"):
        args = list(argv)
        if args and args[-1] == "--out":
            outs[side] = tmp_path / f"{side}.json"
            args.append(str(outs[side]))
        if side == "ref":
            monkeypatch.setattr(sys, "argv", ["bench.py", *args])
            ref.main()
        else:
            bench.main([*args, "--device", "cpu"])
        printed = capsys.readouterr().out.splitlines()
        assert len(printed) == 1
        outs[side + " line"] = printed[0]
    assert twin_calls == ref_calls and len(ref_calls) == {0: 1, 1: 5, 2: 8}[
        ("--curve" in argv) + 2 * ("--curve-xl" in argv)]
    assert outs["twin line"] == outs["ref line"]
    payload = json.loads(outs["twin line"])
    if not argv or argv == ["--out"]:
        assert tuple(payload) == bench.HEADLINE_KEYS
    if "ref" in outs:
        assert outs["twin"].read_text() == outs["ref"].read_text() == outs["ref line"] + "\n"


@pytest.mark.parametrize("n_train,cat_dim", [(50, 0), (50, 2), (512, 0)])
def test_data_equals_the_reference(n_train, cat_dim):
    # bench.py:50-56 and :66-67
    ref_bench = RefTreeFunction(dim=5 - cat_dim, cat_dim=cat_dim, num_cat=5, m=50,
                                function_seed=1)
    rng = np.random.default_rng(0)
    X_ref = ref_bench.domain.sample(n_train, rng)
    y = np.asarray(ref_bench.f(X_ref))
    y_ref = (y - y.mean()) / y.std()
    X, y_std, bounds, ft, _ = bench.problem(n_train, cat_dim)
    assert X.dtype == X_ref.dtype and np.array_equal(X, X_ref)
    np.testing.assert_allclose(y_std, y_ref, rtol=0, atol=1e-12)
    ref_bounds = np.asarray(ref_bench.domain.bounds("bitmask"))
    assert bounds.dtype == ref_bounds.dtype and np.array_equal(bounds, ref_bounds)
    assert np.array_equal(ft, np.asarray(ref_bench.domain.feature_types()))


@pytest.mark.parametrize("kwargs", [
    {},
    {"num_chains": 2, "steps_per_call": 10, "num_trees": 5},
    {"num_chains": 8, "steps_per_call": 20, "leaf_budget": 256, "alpha": 0.9},
])
def test_sampler_params_equal_the_reference(kwargs):
    overrides = {k: v for k, v in kwargs.items() if k not in ("num_chains", "steps_per_call")}
    num_chains = kwargs.get("num_chains", 64)
    steps_per_call = kwargs.get("steps_per_call", 50)
    # bench.py:58-65
    overrides.setdefault("num_trees", 50)
    ref = RefSamplerParams(warmup_steps=0, num_samples=10,
                           steps_per_sample=steps_per_call // 10, num_chains=num_chains,
                           **overrides)
    *_, params = bench.problem(50, 0, **kwargs)
    shared = ({f.name for f in dataclasses.fields(ref)}
              & {f.name for f in dataclasses.fields(params)})
    assert {"warmup_steps", "num_samples", "steps_per_sample", "num_chains",
            "num_trees"} <= shared
    for name in sorted(shared):
        assert getattr(params, name) == getattr(ref, name), name


@pytest.mark.parametrize("n_train", [16, 256])
def test_tiny_run_follows_the_protocol(n_train, monkeypatch):
    calls = []

    def recording(gen, model, *args):
        samples = run_bark_sampler(gen, model, *args)
        calls.append((gen.initial_seed(), model, samples))
        return samples

    monkeypatch.setattr(bench, "run_bark_sampler", recording)
    res = bench.measure(n_train=n_train, num_chains=2, steps_per_call=10, n_calls=2,
                        num_trees=5, device="cpu")
    assert list(res) == ["metric", "value", "unit", "vs_baseline", "n_train", "cat_dim",
                         "num_chains"]
    assert res["metric"] == "forest_mcmc_steps_per_s_per_chip"
    assert res["unit"] == "steps/s/chip" and res["n_train"] == n_train
    assert res["cat_dim"] == 0 and res["num_chains"] == 2
    assert res["value"] > 0 and res["vs_baseline"] == round(res["value"] / 1000, 3)
    assert [seed for seed, *_ in calls] == [0, 1, 2, 3]
    first = calls[0][2]
    assert bool((calls[0][1].forest.active[..., 1:] == 0).all())  # empty forests
    assert torch.equal(calls[0][1].noise, torch.full((2,), 0.1))
    for _, model, _ in calls[1:]:  # the warm model: the first call's last sample
        assert all(torch.equal(a, b[:, -1]) for a, b in zip(model.forest, first.forest))
        assert torch.equal(model.noise, first.noise[:, -1])
        assert torch.equal(model.scale, first.scale[:, -1])
    assert first.noise.shape == (2, 10)


def test_one_untimed_call(monkeypatch):
    """``untimed_calls=1``: the timed calls run on the first call's last
    sample, the lowering given as a sampler override."""
    calls = []

    def recording(gen, model, X, y, bounds, ft, params):
        calls.append((gen.initial_seed(), params))
        return run_bark_sampler(gen, model, X, y, bounds, ft, params)

    monkeypatch.setattr(bench, "run_bark_sampler", recording)
    bench.measure(n_train=16, num_chains=2, steps_per_call=10, n_calls=1, num_trees=5,
                  device="cpu", untimed_calls=1, scan_style="aug")
    assert [seed for seed, _ in calls] == [0, 2]
    assert all(p.scan_style == "aug" for _, p in calls)


def test_no_card_no_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure(n_train=16, num_chains=2, steps_per_call=10, n_calls=1, num_trees=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_imports_only_the_four_modules_of_the_reference_measure():
    for name in ("bench", "bench_turns"):
        source = (REPO / "bark_tpu_torch" / "benchmarks" / f"{name}.py").read_text()
        assert "import jax" not in source and "bark_tpu." not in source, name
    tree = ast.parse((REPO / "bark_tpu_torch" / "benchmarks" / "bench.py").read_text())
    modules = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
               and n.module.startswith("bark_tpu_torch")}
    assert modules == {"bark_tpu_torch.benchmarks.tree_function",
                       "bark_tpu_torch.fitting.params", "bark_tpu_torch.fitting.sampler",
                       "bark_tpu_torch.forest"}


def test_turns_alternate_and_summarise(monkeypatch, tmp_path):
    seen = []

    def fake_side(tree, configs, device=None):
        seen.append(tree)
        rate = 1000.0 + 10 * len(seen) + (5 if tree == bench_turns.REPO else 0)
        return {"seconds": 1.0, "package": str(tree), "results": [
            {"value": rate + c["n_train"]} for c in configs]}

    monkeypatch.setattr(bench_turns, "run_side", fake_side)
    monkeypatch.setattr(bench_turns, "nvidia_smi", lambda: "card, 700.00 W")
    other = tmp_path / "other"
    payload = bench_turns.main(["--runs", "4", "--tree", str(other), "--points", "50,4096,50c",
                                "--out", str(tmp_path / "turns.json")])
    other = other.resolve()
    assert seen == [bench_turns.REPO, other, other, bench_turns.REPO] * 2
    assert [r["order"] for r in payload["runs"]] == [["this", "tree"], ["tree", "this"]] * 2
    assert list(payload["points"]) == ["N=50", "N=4096", "N=50 cat"]
    p = payload["points"]["N=50"]
    assert p["tier"] == "dense" and p["refresh"] == "onesolve"
    assert p["tpu_value_bench_curve_r05"] == 7172.0
    assert p["this"]["runs"] == [1065.0, 1095.0, 1105.0, 1135.0]
    assert p["tree"]["runs"] == [1070.0, 1080.0, 1110.0, 1120.0]
    assert p["this"]["median"] == 1100.0 and p["tree"]["median"] == 1095.0
    assert p["pairs_won_by_this"] == 2
    leaf = payload["points"]["N=4096"]
    assert leaf["tier"] == "leaf" and leaf["scan"] == "coeff" and leaf["leaf_budget"] == 384
    assert json.loads((tmp_path / "turns.json").read_text())["points"] == payload["points"]


def test_turns_worker_measures_the_tree_it_runs_in():
    config = {"n_train": 16, "cat_dim": 0, "num_chains": 2, "steps_per_call": 10,
              "n_calls": 1, "num_trees": 5}
    side = bench_turns.run_side(bench_turns.REPO, [config], "cpu")
    assert side["package"] == "bark_tpu_torch/__init__.py"
    assert side["results"][0]["n_train"] == 16 and side["results"][0]["value"] > 0
    assert bench_turns.parse_points("50,200,50c") == [
        {"n_train": 50, "cat_dim": 0}, {"n_train": 200, "cat_dim": 0},
        {"n_train": 50, "cat_dim": 2}]


def test_turns_points_pin_lowerings():
    """A point's sampler overrides reach ``measure`` and its tier; the
    protocol goes to every point, outside the point's name."""
    points = bench_turns.parse_points("512:scan_style=lowrank;refresh_style=pair,50")
    assert points[0] == {"n_train": 512, "cat_dim": 0, "scan_style": "lowrank",
                         "refresh_style": "pair"}
    assert bench_turns.point_name(points[0]) == "N=512 scan_style=lowrank refresh_style=pair"
    got = bench_turns.tier(512, scan_style="lowrank", refresh_style="pair")
    assert (got["scan"], got["refresh"], got["backend"]) == ("lowrank", "pair", "rank1")
    assert bench_turns.tier(50) == {"tier": "dense", "scan": "plain", "refresh": "onesolve",
                                    "leaf_budget": None}
    assert bench_turns._pairs("steps_per_call=20,n_calls=1", ",") == {
        "steps_per_call": 20, "n_calls": 1}


@pytest.mark.parametrize("config", bench.CURVE_XL, ids=bench_turns.point_name)
def test_each_curve_point_takes_the_reference_tier(config):
    from bark_tpu.fitting.sampler import _leaf_budget, _resolve_styles

    n = config["n_train"]
    ref = _resolve_styles(RefSamplerParams(num_trees=50), n)
    got = bench_turns.tier(n)
    assert (got["scan"], got["refresh"]) == (ref.scan_style, ref.refresh_style)
    assert got["tier"] == ("leaf" if n >= 256 else "dense")
    if got["tier"] == "leaf":
        assert got["leaf_budget"] == _leaf_budget(ref, n)
