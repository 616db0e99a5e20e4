"""The readers of the program's spans (``lib/spans.py``, ``metrics/*``): each
gives its exact number on a hand-built capture, and None on a capture
without spans; the program's own spans, captured on the CPU, are the ones
they read; and on the card a traced run of each cell reports every metric
the cell lists. Run with

    python -m pytest perfbench -q -o addopts="" -p no:cacheprovider
"""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import run as bench_run
from perfbench.lib import registry, spans, tiny
from perfbench.lib.trace import Event, Trace

US = 1000  # the hand-built captures count in microseconds

MCMC = ["propose_launches.mcmc", "scan_launches.mcmc", "refresh_launches.mcmc",
        "propose_syncs.mcmc", "propose_idle_ms.mcmc", "scan_idle_ms.mcmc",
        "refresh_idle_ms.mcmc"]
BO = ["ask_build_ms.bo", "ask_search_ms.bo", "refit_step_launches.bo"]


def _ev(name, start, end=None):
    return Event(name, start * US, 0 if end is None else (end - start) * US)


def _step(t0):
    """A step at ``t0`` (us): the step's span and its three children."""
    return [_ev("bark.step", t0, t0 + 1000), _ev("bark.step.propose", t0 + 100, t0 + 300),
            _ev("bark.step.scan", t0 + 300, t0 + 700),
            _ev("bark.step.refresh", t0 + 700, t0 + 950)]


def mcmc_capture() -> Trace:
    """Two steps. Launches: 1 in the first step's own time, 3 in the
    proposal batches, 5 in the scans, 3 in the refreshes, 1 outside; syncs:
    2 in the proposal batches (a copy beside one, no sync), 1 outside. The
    device idles 20 + 60 us in a proposal batch, 140 + 350 + 950 in scans
    and 180 in a refresh."""
    launch, exc, cu = "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"
    host = _step(0) + _step(1000) + [
        _ev("aten::mm", 140, 210),
        _ev(launch, 50), _ev(launch, 150), _ev(launch, 200), _ev(launch, 400),
        _ev(launch, 500), _ev(launch, 600), _ev(launch, 800),
        _ev(cu, 1150), _ev(exc, 1400), _ev(exc, 1450), _ev(launch, 1800), _ev(launch, 1850),
        _ev(launch, 2100),
        _ev("cudaMemcpyAsync", 240), _ev("cudaStreamSynchronize", 250),
        _ev("cudaStreamSynchronize", 1250), _ev("cudaDeviceSynchronize", 2150),
    ]
    device = [_ev("k", 0, 100), _ev("k", 160, 200), _ev("Memcpy DtoH", 220, 260),
              _ev("k", 400, 450), _ev("k", 800, 820), _ev("k", 1000, 1010),
              _ev("k", 1960, 1980)]
    return Trace(device, host, 2.2e-3)


def bo_capture() -> Trace:
    """Two asks (build 3,000 + 2,000 us; search 5,000 + 6,000 less a nested
    span of 1,000) and one refit step with 4 launches, 2 of them in its
    children, and a launch in the ask."""
    host = [
        _ev("bark.ask", 0, 10000), _ev("bark.ask.build", 1000, 4000),
        _ev("bark.ask.search", 4000, 9000), _ev("bark.inner", 5000, 6000),
        _ev("bark.ask", 20000, 30000), _ev("bark.ask.build", 21000, 23000),
        _ev("bark.ask.search", 23000, 29000),
        *_step(40000),
        _ev("cudaLaunchKernel", 4500), _ev("cudaLaunchKernel", 40050),
        _ev("cudaLaunchKernel", 40150), _ev("cudaLaunchKernel", 40500),
        _ev("cudaLaunchKernel", 40990),
    ]
    return Trace([_ev("k", 0, 10)], host, 0.05)


WANT = {
    "propose_launches.mcmc": 1.5, "scan_launches.mcmc": 2.5, "refresh_launches.mcmc": 1.5,
    "propose_syncs.mcmc": 1.0, "propose_idle_ms.mcmc": 0.04, "scan_idle_ms.mcmc": 0.72,
    "refresh_idle_ms.mcmc": 0.09,
    "ask_build_ms.bo": 2.5, "ask_search_ms.bo": 5.0, "refit_step_launches.bo": 4.0,
}


@pytest.mark.parametrize("metric", MCMC + BO)
def test_each_reader_gives_its_number_and_none_without_spans(metric):
    reader = registry.metric_reader(metric)
    capture = mcmc_capture() if metric in MCMC else bo_capture()
    assert reader.read({"host_trace": capture}) == pytest.approx(WANT[metric], rel=1e-12)
    plain = Trace(capture.device, [e for e in capture.host if not e.name.startswith("bark.")],
                  capture.window_s)
    assert reader.read({"host_trace": plain}) is None
    assert reader.read({}) is None
    if metric.startswith("ask_"):  # a capture of steps alone holds no ask
        assert reader.read({"host_trace": mcmc_capture()}) is None


def test_launches_and_idle_add_up_by_span():
    s = spans.Spans(mcmc_capture())
    assert s.calls_by_span("launches") == {"bark.step": 1, "bark.step.propose": 3,
                                           "bark.step.scan": 5, "bark.step.refresh": 3,
                                           None: 1}
    assert s.calls_by_span("syncs") == {"bark.step.propose": 2, None: 1}
    assert s.idle_ns_by_span() == {"bark.step.propose": 80 * US, "bark.step.scan": 1440 * US,
                                   "bark.step.refresh": 180 * US}


def test_the_programs_spans_are_the_ones_read(tmp_path):
    """A sampler call and an ask of the shrunk benchmark, captured on the
    CPU: the readers find the program's spans (no launch, no device event
    there)."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.lib.trace import _events

    bench = tiny.make(tmp_path)
    for cell, steps in (("mcmc.treefn5.n50", 2), ("bo.treefn5.n50", None)):
        c = registry.load_cell(cell, bench)
        work = c.entry.Workload(c.config, c.traffic, c.limits, 5, torch.device("cpu"))
        work.setup()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if steps:
                work._call(work.warm, 7, work.params.with_(num_samples=1,
                                                           steps_per_sample=steps))
            else:
                work.strategy.ask(1)
        device, host = _events(prof)
        ctx = {"host_trace": Trace(device, host, 0.0)}
        found = spans.of(ctx)
        if steps:
            assert found.count("bark.step") == steps
            for name in ("bark.step.propose", "bark.step.scan", "bark.step.refresh"):
                assert found.count(name) == steps
            assert registry.metric_reader("scan_launches.mcmc").read(ctx) == 0.0
        else:
            assert [found.count(n) for n in ("bark.ask", "bark.ask.build", "bark.ask.search")] \
                == [1, 1, 1]
            assert registry.metric_reader("ask_search_ms.bo").read(ctx) > 0
        work.recorder.uninstall()
        if not steps:
            work.steps.uninstall()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mcmc.treefn5.n50", "bo.treefn5.n50"])
def test_a_traced_run_reports_every_metric_of_its_cell(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code, result = bench_run.run(["--workload", cell, "--seed", str(2**40 + 5), "--seconds",
                                  "3", "--trace", "1"])
    assert code == 0 and result["correct"] is True, result
    spec = json.loads((registry.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer"]
            if registry.reports(m, cell, spec["end_to_end"])}
    # a roofline is left out where the profiler dropped a kernel's events
    rooflines = {"k1_roofline.mcmc", "k2_roofline.mcmc", "k1_roofline.bo", "k2_roofline.bo"}
    assert want - rooflines <= set(result["metrics"])
