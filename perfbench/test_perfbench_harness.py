"""The harness on the CPU at a tiny size: discovery by name, the result
line, the import check, and that faults planted under the timed path make
``correct`` false. Run with

    python -m pytest perfbench -q -o addopts="" -p no:cacheprovider
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

from perfbench import run as bench_run
from perfbench.lib import registry, tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def one_run(bench, cell, seed=2**33 + 17, seconds=0.5):
    code, result = bench_run.run(["--workload", cell, "--seed", str(seed), "--seconds",
                                  str(seconds), "--trace", "0"], device=CPU, bench_dir=bench)
    assert code == 0
    return result


@pytest.mark.parametrize("cell", ["mcmc.treefn5.n50", "bo.treefn5.n50"])
def test_result_line(bench, cell):
    result = one_run(bench, cell)
    assert list(result) == KEYS
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if registry.reports(m, cell, spec["end_to_end"])}
    assert set(result["metrics"]) == want
    limits = json.loads((bench / "limits" / f"{cell}.json").read_text())
    assert set(result["compared"]) == set(limits)
    json.dumps(result)


def test_new_parts_are_found_by_name(bench, tmp_path):
    """A cell, a traffic mix and a metric added as files, with entries in
    BENCHMARK.json, are found with no other file edited."""
    copy = tiny.make(tmp_path)
    (copy / "traffic" / "mcmc_n24.json").write_text(
        (copy / "traffic" / "mcmc_n50.json").read_text().replace('"n_train": 16', '"n_train": 24'))
    (copy / "limits" / "mcmc.treefn5.n24.json").write_text(
        (copy / "limits" / "mcmc.treefn5.n50.json").read_text())
    (copy / "metrics" / "calls_seen.mcmc.py").write_text(
        "def read(ctx):\n    return ctx.get('steps_per_s')\n")
    spec_path = copy.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "mcmc.treefn5.n24", "config": "bark_mcmc_treefn5",
                              "traffic": "mcmc_n24", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("mcmc.treefn5.n24")
    spec["per_layer"].append({"name": "calls_seen.mcmc", "unit": "steps/s", "better": "higher",
                              "source": "host_clock", "layer": "test",
                              "moves": "mcmc_steps_per_s"})
    spec_path.write_text(json.dumps(spec))
    cell = registry.load_cell("mcmc.treefn5.n24", copy)
    assert cell.traffic["n_train"] == 24
    assert "calls_seen.mcmc" in [m["name"] for m in cell.per_layer]
    assert registry.metric_reader("calls_seen.mcmc", copy).read({"steps_per_s": 3.0}) == 3.0
    result = one_run(copy, "mcmc.treefn5.n24")
    assert result["correct"] is True and "mcmc_steps_per_s" in result["metrics"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bark_tpu_torch_extra", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bark_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert bench_run.forbidden_modules() == ["bark_tpu", "jaxlib"]


def test_run_refuses_a_loaded_forbidden_module(bench, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    code, result = bench_run.run(["--workload", "mcmc.treefn5.n50", "--seed", "3", "--seconds",
                                  "0.2"], device=CPU, bench_dir=bench)
    assert (code, result) == (3, None)


def test_run_refuses_without_a_card(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, result = bench_run.run(["--workload", "mcmc.treefn5.n50", "--seed", "3", "--seconds",
                                  "0.2"], bench_dir=bench)
    assert (code, result) == (2, None)


def test_reference_imports_nothing_of_the_program():
    """The reference, the data and the roofline load no module of the
    program or of JAX, in a fresh interpreter."""
    import subprocess

    code = ("import sys; import perfbench.reference.gp, perfbench.reference.forest, "
            "perfbench.reference.moves, "
            "perfbench.data.tree_function, perfbench.roofline.counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bark_tpu', 'bark_tpu_torch'}))")
    root = str(registry.BENCH_DIR.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# --- faults under the timed path ---------------------------------------------


def _step_unchanged(monkeypatch):
    from bark_tpu_torch.fitting import sampler

    real = sampler.step_with_info

    def step(state, *args, **kwargs):
        return state, real(state, *args, **kwargs)[1]

    monkeypatch.setattr(sampler, "step_with_info", step)


def _half_batch_mcmc(monkeypatch):
    """Only the first half of the chains steps; the rest keep their state."""
    from bark_tpu_torch.fitting import sampler

    real = sampler.step_with_info

    def mix(old, new, stepped):
        if new is None:
            return None
        if isinstance(new, torch.Tensor):
            return torch.where(stepped.view(-1, *[1] * (new.dim() - 1)), new, old)
        return type(new)(*[mix(o, n, stepped) for o, n in zip(old, new)])

    def step(state, *args, **kwargs):
        new, info = real(state, *args, **kwargs)
        c = state.noise.shape[0]
        return mix(state, new, torch.arange(c) < c // 2), info

    monkeypatch.setattr(sampler, "step_with_info", step)


def _altered_mll(monkeypatch):
    from bark_tpu_torch.fitting import sampler

    real = sampler.run_chain

    def run_chain(*args, **kwargs):
        out = real(*args, **kwargs)
        state = out.state._replace(mll=out.state.mll + 1e-2 * out.state.mll.abs())
        return out._replace(state=state)

    monkeypatch.setattr(sampler, "run_chain", run_chain)


def _half_samples_acquisition(monkeypatch):
    """The acquisition's mean over the first half of the samples."""
    from bark_tpu_torch.optimizer import acquisition

    real = acquisition._evaluate_acquisition_dense

    def evaluate(acq, *args, **kwargs):
        half = acq.noise.shape[0] // 2
        part = type(acq)(*[t if t is acq.train_mask else t[:half] if hasattr(t, "shape")
                           else type(t)(*[f[:half] for f in t]) for t in acq])
        return real(part, *args, **kwargs)

    monkeypatch.setattr(acquisition, "_evaluate_acquisition_dense", evaluate)


def _altered_scores(monkeypatch):
    from bark_tpu_torch.optimizer import acquisition

    real = acquisition._evaluate_acquisition_dense
    monkeypatch.setattr(acquisition, "_evaluate_acquisition_dense",
                        lambda *a, **k: real(*a, **k) * 1.01)


def _altered_point(monkeypatch):
    """The search returns the mirror image of the point it settled on."""
    from bark_tpu_torch.strategies import tree_kernel

    real = tree_kernel.propose

    def propose(*args, **kwargs):
        point, value = real(*args, **kwargs)
        return (1.0 - point).astype(point.dtype), value

    monkeypatch.setattr(tree_kernel, "propose", propose)


def _accept_by_prior_alone(monkeypatch):
    """The move scan accepts on the proposal's ratio, the MLL term dropped."""
    from bark_tpu_torch.fitting import sampler

    real = sampler._accept

    def accept(log_q_prior, beta, new_mll, cur_mll, log_u, zero):
        return real(log_q_prior, beta, cur_mll, cur_mll, log_u, zero)

    monkeypatch.setattr(sampler, "_accept", accept)


def _bf16_scan(monkeypatch):
    """The move scan's 2x2 capacitance and projections rounded to bfloat16."""
    from bark_tpu_torch.fitting import sampler

    real = sampler._rank2_terms
    low = lambda t: t.to(torch.bfloat16).to(t.dtype)  # noqa: E731
    monkeypatch.setattr(sampler, "_rank2_terms", lambda G, t, *a, **k: real(low(G), low(t), *a, **k))


def _merge_every_proposal(monkeypatch):
    """The step keeps every proposal, accepted or not."""
    from bark_tpu_torch.fitting import sampler

    real = sampler._merge_accepted
    monkeypatch.setattr(sampler, "_merge_accepted",
                        lambda packed0, state, batch, accepts: real(
                            packed0, state, batch, torch.ones_like(accepts)))


FAULTS = [
    ("mcmc.treefn5.n50", _step_unchanged, "unmoved_chains"),
    ("mcmc.treefn5.n50", _accept_by_prior_alone, "accept_gap"),
    ("mcmc.treefn5.n50", _bf16_scan, "accept_gap"),
    ("mcmc.treefn5.n50", _merge_every_proposal, "merge_mismatch"),
    ("bo.treefn5.n50", _accept_by_prior_alone, "accept_gap"),
    ("bo.treefn5.n50", _bf16_scan, "accept_gap"),
    ("mcmc.treefn5.n50", _half_batch_mcmc, "unmoved_chains"),
    ("mcmc.treefn5.n50", _altered_mll, "mll_gap"),
    ("bo.treefn5.n50", _step_unchanged, "unmoved_chains"),
    ("bo.treefn5.n50", _half_samples_acquisition, "acq_gap"),
    ("bo.treefn5.n50", _altered_scores, "acq_gap"),
    ("bo.treefn5.n50", _altered_point, "better_than_point"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(bench, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    result = one_run(bench, cell)
    assert result["correct"] is False
    got = result["compared"][number]
    assert not got["value"] <= got["limit"]


def test_a_number_not_computed_makes_the_run_not_correct(bench, monkeypatch, capsys):
    """A step the recorder never saw (the sampler's step renamed or moved)
    leaves the scan's numbers uncomputed: the run is not correct, and
    standard error names them."""
    from perfbench.lib import steps

    monkeypatch.setattr(steps.StepRecorder, "take", lambda self: None)
    result = one_run(bench, "mcmc.treefn5.n50")
    assert result["correct"] is False
    assert "accept_gap" not in result["compared"]
    assert "not compared, so not correct: accept_gap, merge_mismatch, scan_flips" in (
        capsys.readouterr().err)


def test_an_ask_with_no_scored_search_fails(bench):
    """An acquisition the search recorder does not know (renamed) leaves the
    ask with no scored search: each such iteration counts as failed."""
    from bark_tpu_torch.optimizer import acquisition

    kinds = (acquisition.AcquisitionState, acquisition.AcquisitionStateLR)
    names = [k.__name__ for k in kinds]
    try:
        for k in kinds:
            k.__name__ = "Renamed" + k.__name__
        result = one_run(bench, "bo.treefn5.n50")
    finally:
        for k, name in zip(kinds, names):
            k.__name__ = name
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0


# --- the control ---------------------------------------------------------------


@pytest.mark.parametrize("cell", ["mcmc.treefn5.n50", "bo.treefn5.n50"])
def test_the_control_is_not_correct(bench, cell):
    """The reference computed in TF32 in the program's place fails a limit
    that the program's own outputs meet."""
    c = registry.load_cell(cell, bench)
    work = c.entry.Workload(c.config, c.traffic, c.limits, 2**35 + 1, CPU)
    work.setup()
    for _ in range(3):
        work.unit()
    work.release()
    failed = []
    for claim in work.claims:
        program = work.readings(claim, CPU)
        assert all(program[k] <= v for k, v in c.limits.items() if k in program), program
        control = work.readings(claim, CPU, "tf32")
        failed += [k for k, v in c.limits.items() if k in control and not control[k] <= v]
    assert failed
