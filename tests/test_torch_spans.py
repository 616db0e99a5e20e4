"""The program's spans (``utils/profiling.annotate``) on the CPU, at tiny
sizes: where each sits and what it encloses, that it is a plain host
operation of the capture (nothing mirrored onto the device's timeline),
that it costs a shared null context with no profiler running, and that a
step's outputs do not depend on whether a profiler records."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bark_tpu_torch.strategies.tree_kernel as tk
from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, run_chain
from bark_tpu_torch.forest import FOREST_FIELDS, create_empty_forest
from bark_tpu_torch.utils import profiling

STEP_SPANS = ("bark.step.propose", "bark.step.scan", "bark.step.refresh")
ASK_SPANS = ("bark.ask.build", "bark.ask.search")
SMALL = dict(num_trees=4, node_limit=16, max_depth=6, num_chains=2)


def _inputs(n=16):
    bench = map_benchmark("TreeFunction", dim=2, m=5, function_seed=1)
    X = bench.domain.sample(n, np.random.default_rng(0))
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    return (bench, torch.as_tensor(X), torch.as_tensor(y, dtype=torch.float32),
            torch.as_tensor(bench.domain.bounds("bitmask")),
            torch.as_tensor(bench.domain.feature_types()))


def _chain(params, seed=0):
    _, X, y, bounds, ft = _inputs()
    c = params.num_chains
    model = BARKModel(create_empty_forest(params.num_trees, params.node_limit, (c,)),
                      torch.full((c,), 0.1), torch.ones(c))
    return run_chain(torch.Generator().manual_seed(seed), model, X, y, bounds, ft, params)


def _spans(prof) -> list:
    """The capture's ``bark.`` events, in order of start."""
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("bark.")]
    return sorted(events, key=lambda e: e.start_ns())


def _inside(child, parent) -> bool:
    return (parent.start_ns() <= child.start_ns()
            and child.start_ns() + child.duration_ns() <= parent.start_ns() + parent.duration_ns())


def _check_nesting(spans, root, children, count):
    """``count`` root spans, each holding exactly one of each child, and no
    child outside a root."""
    roots = [e for e in spans if e.name() == root]
    assert len(roots) == count
    for name in children:
        found = [e for e in spans if e.name() == name]
        assert len(found) == count, name
        for r in roots:
            assert sum(_inside(e, r) for e in found) == 1, (root, name)
    for e in spans:
        assert not e.is_user_annotation(), e.name()
        assert "CPU" in str(e.device_type()), e.name()


@pytest.mark.parametrize("backend", ["rank1", "chol", "woodbury"])
def test_each_step_holds_its_proposal_batch_scan_and_refresh(backend):
    params = SamplerParams(warmup_steps=0, num_samples=1, steps_per_sample=2,
                           kernel_backend=backend, **SMALL)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _chain(params)
    _check_nesting(_spans(prof), "bark.step", STEP_SPANS, 2)


def test_each_ask_holds_its_build_and_search(tmp_path):
    bench, *_ = _inputs()
    X = bench.domain.sample(8, np.random.default_rng(1))
    params = SamplerParams(warmup_steps=2, num_samples=2, steps_per_sample=1, **SMALL)
    s = tk.make_strategy("BARK", bench.domain, seed=0, params=params, num_candidates=64,
                         num_rounds=1, device="cpu", dedup=False)
    s.tell(X, bench.f(X))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.ask(1)
    spans = _spans(prof)
    _check_nesting(spans, "bark.ask", ASK_SPANS, 1)
    assert not any(e.name().startswith("bark.step") for e in spans)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if str(e.get("name")).startswith("bark.")}
    assert cats == {"cpu_op"}


def test_annotate_is_a_shared_null_context_with_no_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("bark.step")
    assert off is profiling.annotate("bark.ask")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("bark.step") is not off


def test_a_step_is_bitwise_the_same_under_a_profiler():
    params = SamplerParams(warmup_steps=0, num_samples=2, steps_per_sample=1, **SMALL)
    plain = _chain(params, seed=3)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _chain(params, seed=3)
    for k in FOREST_FIELDS:
        assert torch.equal(getattr(plain.samples.forest, k), getattr(traced.samples.forest, k)), k
    for a, b in ((plain.samples.noise, traced.samples.noise),
                 (plain.samples.scale, traced.samples.scale), (plain.mll, traced.mll),
                 (plain.state.kern.K_inv, traced.state.kern.K_inv),
                 (plain.tree_accept_rate, traced.tree_accept_rate)):
        assert torch.equal(a, b)
