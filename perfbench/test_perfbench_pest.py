"""The categorical BO cell ``bo.pest25.n120`` on the CPU at a tiny size (and
two short runs of it on the card, marked ``cuda``).

``entries/bo_mixed.py`` runs the BO family on PestControl with the forests
judged by ``reference/validity.py``, categorical points held to whole
levels, and every Thompson search judged against
``reference/thompson.py``. ``lib/tiny.py`` shrinks only the cells it knows,
so the tests here shrink the new cell's copy themselves. Run with

    python -m pytest perfbench -q -o addopts="" -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.data import pest as frozen
from perfbench.lib import registry, tiny
from perfbench.lib.trace import Event, Trace
from perfbench.test_perfbench_harness import KEYS, _accept_by_prior_alone, one_run

CPU = torch.device("cpu")
CELL = "bo.pest25.n120"
CONFIG = "perfbench/configs/bark_bo_pestcontrol.json"


def shrink(dest):
    """``tiny.make``'s copy with the new cell shrunk as tiny shrinks ``bo``:
    8 trees, 2 chains x 1 x 3 steps, warm-up 10, 64 candidates x 1 round,
    N 12-14 in episodes of 3."""
    bench = tiny.make(dest)
    path = bench.parent / CONFIG
    cfg = json.loads(path.read_text())
    cfg["sampler"].update(num_trees=8, num_chains=2, num_samples=1, steps_per_sample=3,
                          warmup_steps=10)
    cfg["strategy"].update(num_candidates=64, num_rounds=1)
    path.write_text(json.dumps(cfg))
    path = bench / "traffic" / "bo_n120.json"
    traffic = json.loads(path.read_text())
    traffic.update(n_init=12, episode=3)
    path.write_text(json.dumps(traffic))
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return shrink(tmp_path_factory.mktemp("bench"))


def workload(bench, seed=2**35 + 1, units=3):
    c = registry.load_cell(CELL, bench)
    work = c.entry.Workload(c.config, c.traffic, c.limits, seed, CPU)
    work.setup()
    for _ in range(units):
        work.unit()
    return c, work


# --- the frozen data ------------------------------------------------------------


def test_pest_copy_equals_the_port():
    from bark_tpu_torch.benchmarks.pest import PestControl

    port, copy = PestControl(seed=11), frozen.PestControl(seed=11)
    dom = port.domain
    np.testing.assert_array_equal(copy.feature_types(), dom.feature_types())
    for enc in ("ordinal", "bitmask"):
        np.testing.assert_array_equal(copy.bounds(enc), dom.bounds(enc))
    X = copy.sample(9, np.random.default_rng(4))
    np.testing.assert_array_equal(X, dom.sample(9, np.random.default_rng(4)))
    np.testing.assert_array_equal(copy.f(X), port.f(X))
    np.testing.assert_array_equal(copy.f(X), port.f(X))  # the generators advance alike
    copy.reseed(11)
    np.testing.assert_array_equal(copy.f(X), PestControl(seed=11).f(X))


def test_new_files_import_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.thompson, perfbench.data.pest, "
            "perfbench.roofline.thompson; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bark_tpu', 'bark_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(registry.BENCH_DIR.parent), check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# --- the cell, run whole ------------------------------------------------------------


def test_result_line(bench):
    result = one_run(bench, CELL)
    assert list(result) == KEYS
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if registry.reports(m, CELL, spec["end_to_end"])}
    assert set(result["metrics"]) == want == {"bo_iter_s", "setup_s"}
    limits = json.loads((bench / "limits" / f"{CELL}.json").read_text())
    assert set(result["compared"]) == set(limits)


def test_the_check_runs_its_own_thompson_search(bench):
    """A window with no retry: the check still judges one Thompson search,
    made after the window on the last ask's posterior, and the counters read
    no retry."""
    c, work = workload(bench)
    ctx = work.layer_context(1.0)
    assert (ctx["asks"], ctx["duplicate_asks"], ctx["random_asks"]) == (3, 0, 0)
    assert registry.metric_reader("dedup_share.bo", bench).read(ctx) == 0.0
    work.release()
    assert [len(claim.get("thompson", ())) for claim in work.claims] == [0, 0, 1]
    got = work.readings(work.claims[-1], CPU)
    assert got["ts_gap"] <= c.limits["ts_gap"] and got["outside"] == 0


def test_window_thompson_searches_are_judged(bench, monkeypatch):
    """Asks whose LCB point repeats take the Thompson retry: each is judged,
    and the counters and the share read them."""
    from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy

    real = TreeKernelStrategy._is_duplicate
    seen = {}

    def first_repeats(self, candidate):  # the LCB point repeats, the Thompson one not
        seen[id(self)] = seen.get(id(self), 0) + 1
        return seen[id(self)] % 2 == 1 or real(self, candidate)

    monkeypatch.setattr(TreeKernelStrategy, "_is_duplicate", first_repeats)
    c, work = workload(bench)
    ctx = work.layer_context(1.0)
    assert (ctx["asks"], ctx["duplicate_asks"], ctx["random_asks"]) == (3, 3, 0)
    assert registry.metric_reader("dedup_share.bo", bench).read(ctx) == 100.0
    assert work.failed == 0
    work.release()
    assert [len(claim["thompson"]) for claim in work.claims] == [1, 1, 1]
    for claim in work.claims:
        got = work.readings(claim, CPU)
        assert all(got[k] <= v for k, v in c.limits.items() if k in got), got


# --- faults under the timed path ------------------------------------------------------


def _point_level(value):
    """The ask returns its point with the first coordinate set to
    ``value``; the objective is run at the nearest level (the simulator
    knows 5 actions), so that the point reaches the check."""

    def fault(monkeypatch):
        from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy

        real_ask, real_score = TreeKernelStrategy.ask, frozen.score

        def ask(self, *args, **kwargs):
            c = real_ask(self, *args, **kwargs).copy()
            c[0, 0] = value
            return c

        monkeypatch.setattr(TreeKernelStrategy, "ask", ask)
        monkeypatch.setattr(frozen, "score", lambda x, rng: real_score(np.clip(x, 0, 4), rng))

    fault.__name__ = f"_point_level_{value}"
    return fault


def _stray_mask_bit(monkeypatch):
    """A categorical split's mask carries a bit of no category (bit 5 of an
    input with 5 levels)."""
    from bark_tpu_torch.fitting import proposals

    real = proposals._sample_split_from_bounds

    def draw(noise, lb, ub, ftype):
        thr = real(noise, lb, ub, ftype)
        return torch.where(ftype == proposals.FEAT_CAT, thr + 32, thr)

    monkeypatch.setattr(proposals, "_sample_split_from_bounds", draw)


def _altered_theta(monkeypatch):
    from bark_tpu_torch.strategies import tree_kernel

    real = tree_kernel.build_acquisition_ts
    monkeypatch.setattr(tree_kernel, "build_acquisition_ts",
                        lambda *a, **k: (lambda acq: acq._replace(theta=acq.theta + 1e-2))(
                            real(*a, **k)))


def _altered_lcb_scores(monkeypatch):
    from bark_tpu_torch.optimizer import acquisition

    real = acquisition._evaluate_acquisition_dense
    monkeypatch.setattr(acquisition, "_evaluate_acquisition_dense",
                        lambda *a, **k: real(*a, **k) * 1.01)


FAULTS = [
    (_point_level(5.0), "outside"),
    (_point_level(2.5), "outside"),
    (_stray_mask_bit, "bad_nodes"),
    (_altered_theta, "ts_gap"),
    (_altered_lcb_scores, "acq_gap"),
    (_accept_by_prior_alone, "accept_gap"),
]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f.__name__.strip("_") for f, _ in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(bench, monkeypatch, fault, number):
    fault(monkeypatch)
    result = one_run(bench, CELL)
    assert result["correct"] is False
    got = result["compared"][number]
    assert not got["value"] <= got["limit"]


def test_a_random_answer_fails_its_iteration(bench, monkeypatch):
    """Every point repeats, so every ask ends in a random answer: each such
    iteration counts as failed."""
    from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy

    monkeypatch.setattr(TreeKernelStrategy, "_is_duplicate", lambda self, candidate: True)
    result = one_run(bench, CELL)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0


def test_the_control_is_not_correct(bench, monkeypatch):
    """The reference computed in TF32 in the program's place fails a limit
    that the program's own outputs meet."""
    c, work = workload(bench, seed=2**36 + 7)
    work.release()
    failed = []
    for claim in work.claims:
        program = work.readings(claim, CPU)
        assert all(program[k] <= v for k, v in c.limits.items() if k in program), program
        control = work.readings(claim, CPU, "tf32")
        failed += [k for k, v in c.limits.items() if k in control and not control[k] <= v]
    assert failed


# --- the readers of the new metrics -----------------------------------------------------


def _capture(dedup_us):
    """Two asks; a retry span of each length in ``dedup_us`` inside the
    first."""
    us = 1000
    host = [Event("bark.ask", 0, 10000 * us), Event("bark.ask.build", 100 * us, 900 * us),
            Event("bark.ask.search", 1000 * us, 3000 * us),
            Event("bark.ask", 20000 * us, 5000 * us)]
    start = 4000
    for d in dedup_us:
        host.append(Event("bark.ask.dedup", start * us, d * us))
        start += d + 10
    return Trace([Event("k", 0, 10 * us)], host, 0.05)


def test_the_readers_read_no_retry_as_zero_and_a_retry_as_a_number():
    dedup = registry.metric_reader("ask_dedup_ms.bo")
    share = registry.metric_reader("dedup_share.bo")
    assert dedup.read({"host_trace": _capture([])}) == 0.0
    assert dedup.read({"host_trace": _capture([3000])}) == pytest.approx(1.5, rel=1e-12)
    assert dedup.read({"host_trace": _capture([3000, 1000])}) == pytest.approx(2.0, rel=1e-12)
    no_ask = Trace([], [Event("bark.step", 0, 10)], 0.01)
    assert dedup.read({"host_trace": no_ask}) is None and dedup.read({}) is None
    assert share.read({"duplicate_asks": 0, "asks": 7}) == 0.0
    assert share.read({"duplicate_asks": 2, "asks": 8}) == 25.0
    assert share.read({"duplicate_asks": None, "asks": 8}) is None
    assert share.read({}) is None


def test_the_programs_retry_span_is_the_one_read(bench, monkeypatch):
    """An ask of the shrunk cell captured on the CPU, with and without a
    retry: the reader finds the program's span."""
    from torch.profiler import ProfilerActivity, profile

    from bark_tpu_torch.strategies.tree_kernel import TreeKernelStrategy
    from perfbench.lib.trace import _events

    c, work = workload(bench, units=0)
    dedup = registry.metric_reader("ask_dedup_ms.bo", bench)
    real = TreeKernelStrategy._is_duplicate
    for repeats in (False, True):
        monkeypatch.setattr(TreeKernelStrategy, "_is_duplicate",
                            lambda self, cand, _r=repeats, _s=[]: (
                                _s.append(1), (_r and len(_s) % 2 == 1) or real(self, cand))[1])
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work.strategy.ask(1)
        device, host = _events(prof)
        got = dedup.read({"host_trace": Trace(device, host, 0.0)})
        assert (got > 0) if repeats else (got == 0.0)
    work.recorder.uninstall()
    work.steps.uninstall()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from perfbench import run as bench_run

    code, result = bench_run.run(["--workload", CELL, "--seed", str(2**40 + 3), "--seconds",
                                  "3", "--trace", str(trace)])
    assert code == 0
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0
        for name in ("dedup_share.bo", "ask_dedup_ms.bo", "k1_roofline.bo", "k2_roofline.bo",
                     "refit_step_launches.bo"):
            assert name in result["metrics"], name
