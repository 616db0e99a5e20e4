"""The port's BO loop on PestControl (25 categorical inputs of 5 levels), on
the CPU at a small size, against the benchmark's plain float64 references.

One ask's LCB scores (the candidates and the point) against
``perfbench/reference/gp.lcb``, a Thompson search's scores against
``perfbench/reference/thompson.py`` on the same posterior sample and normal
vector, the refit's forests against ``perfbench/reference/validity.py``
(categorical masks judged as bitmasks), the point a whole level, and the
duplicate retry's span and counters. No JAX here: the references are plain
PyTorch.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bark_tpu_torch.strategies.tree_kernel as tk
from bark_tpu_torch.benchmarks.pest import PestControl
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.optimizer import search
from perfbench.reference import gp, thompson, validity

SMALL = dict(num_trees=8, num_chains=2, num_samples=1, steps_per_sample=3, warmup_steps=3,
             node_limit=64, max_depth=16)
JITTER = 1e-6  # the program's (ops/linalg.JITTER) and the benchmark config's
KAPPA = 1.96
# The program scores in float32 from float32 posterior states; the references
# are float64. At N = 12 (K's condition number at most ~1e3 with noise near
# 0.1) float32 rounding moves a score by ~1e-6; 1e-4 leaves two orders of
# room and still catches a dropped sample or tree (a change of ~1e-1).
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def fitted():
    torch.manual_seed(0)
    bench = PestControl(seed=0)
    X = bench.domain.sample(12, np.random.default_rng(1))
    s = tk.make_strategy("BARK", bench.domain, seed=3, params=SamplerParams(**SMALL),
                         num_candidates=64, num_rounds=1, device="cpu")
    s.tell(X, bench.f(X))
    return s, bench


def _forest(model) -> dict:
    """The model's samples as the references take them: fields (S, m, nl)."""
    f = model.forest
    return {k: v.reshape(-1, *v.shape[-2:]) for k, v in zip(f._fields, f)}


def _standard(y):
    y = np.asarray(y, np.float64)
    return torch.as_tensor((y - y.mean()) / max(y.std(), 1e-6))


def _record(monkeypatch):
    """Record every search of an ask: its acquisition, the scored batches,
    the point and value; and every Thompson draw (pick, eps)."""
    searches, draws = [], []
    propose, evaluate, draw = tk.propose, search.evaluate_acquisition, tk.draw_acquisition_ts

    def recorded_propose(d, acq, *a, **k):
        searches.append({"acq": acq, "batches": []})
        point, value = propose(d, acq, *a, **k)
        searches[-1].update(point=np.asarray(point, np.float64), value=float(value))
        return point, value

    def recorded_evaluate(acq, batch, *a, **k):
        scores = evaluate(acq, batch, *a, **k)
        searches[-1]["batches"].append((batch.clone(), scores.clone()))
        return scores

    def recorded_draw(*a, **k):
        out = draw(*a, **k)
        draws.append(out)
        return out

    monkeypatch.setattr(tk, "propose", recorded_propose)
    monkeypatch.setattr(search, "evaluate_acquisition", recorded_evaluate)
    monkeypatch.setattr(tk, "draw_acquisition_ts", recorded_draw)
    return searches, draws


def _points(s):
    """Every scored candidate and the point, float64 (B + 1, D), with the
    program's scores there (the value the search returned at the point)."""
    cands = torch.cat([b for b, _ in s["batches"]]).double()
    scores = torch.cat([v for _, v in s["batches"]]).double()
    pts = torch.cat([cands, torch.as_tensor(s["point"])[None]])
    return pts, torch.cat([scores, torch.tensor([s["value"]], dtype=torch.float64)])


def _duplicate_once(monkeypatch, strategy, times=1):
    """The first ``times`` duplicate tests of each ask say yes."""
    calls = []

    def is_duplicate(candidate):
        calls.append(1)
        return len(calls) <= times

    monkeypatch.setattr(strategy, "_is_duplicate", is_duplicate)
    return calls


def test_lcb_scores_and_point_against_the_reference(fitted, monkeypatch):
    s, bench = fitted
    searches, _ = _record(monkeypatch)
    c = s.ask(1)
    assert len(searches) == 1 and type(searches[0]["acq"]).__name__ == "AcquisitionState"
    pts, got = _points(searches[0])
    model = s.surrogate.model
    ft = torch.as_tensor(bench.domain.feature_types())
    ref = gp.lcb(_forest(model), model.noise.reshape(-1), model.scale.reshape(-1),
                 torch.as_tensor(s.X), _standard(s.y), pts, ft, JITTER, KAPPA)
    assert (got - ref).abs().max() < SCORE_TOL
    assert (ref[:-1] >= ref[-1] - SCORE_TOL).all()  # no candidate beats the point
    # the point: in range and a whole level of every input
    lo, hi = bench.domain.bounds("ordinal").T
    assert (lo <= c[0]).all() and (c[0] <= hi).all()
    assert np.array_equal(c[0], np.round(c[0]))


def test_thompson_scores_against_the_reference(fitted, monkeypatch):
    s, bench = fitted
    searches, draws = _record(monkeypatch)
    _duplicate_once(monkeypatch, s)
    s.ask(1)
    assert [type(x["acq"]).__name__ for x in searches] == ["AcquisitionState",
                                                          "AcquisitionStateTS"]
    (pick, eps), = draws
    pts, got = _points(searches[1])
    model = s.surrogate.model
    f = {k: v[pick] for k, v in _forest(model).items()}
    ft = torch.as_tensor(bench.domain.feature_types())
    args = (f, float(model.noise.reshape(-1)[pick]), float(model.scale.reshape(-1)[pick]),
            torch.as_tensor(s.X), _standard(s.y), eps, pts, ft, JITTER)
    ref = thompson.scores(*args)
    # float32 weights from the (r, r) leaf-space factor, r = 8 x 32; the
    # scores are sums of 8 weights of magnitude ~1, so rounding moves them
    # by ~1e-6
    assert (got - ref).abs().max() < SCORE_TOL
    assert (ref[:-1] >= ref[-1] - SCORE_TOL).all()
    # the TF32 control misses by far more than the program
    control = thompson.scores(*args, precision="tf32").double()
    assert (control - ref).abs().max() > (got - ref).abs().max()


def test_refit_forests_are_valid_bitmask_trees(fitted):
    s, bench = fitted
    forest = _forest(s.surrogate.model)
    bounds = torch.as_tensor(bench.domain.bounds("ordinal"))
    ft = torch.as_tensor(bench.domain.feature_types())
    assert validity.invalid_nodes(forest, bounds, ft).sum() == 0
    split = forest["active"] & ~forest["is_leaf"]
    assert split.any()  # every split categorical: the bitmask check has work


def test_a_duplicate_moves_the_counter_and_opens_the_span(fitted, monkeypatch):
    s, _ = fitted
    before = (s.duplicate_asks, s.random_asks, s.fallbacks)
    _duplicate_once(monkeypatch, s)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.ask(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("bark.ask.dedup") == 1
    assert names.count("bark.ask.build") == names.count("bark.ask.search") == 2
    assert (s.duplicate_asks, s.random_asks, s.fallbacks) == (before[0] + 1, before[1],
                                                              before[2])


def test_a_persisted_duplicate_moves_random_asks(fitted, monkeypatch):
    s, bench = fitted
    before = (s.duplicate_asks, s.random_asks)
    _duplicate_once(monkeypatch, s, times=2)
    c = s.ask(1)
    assert (s.duplicate_asks, s.random_asks) == (before[0] + 1, before[1] + 1)
    lo, hi = bench.domain.bounds("ordinal").T
    assert (lo <= c[0]).all() and (c[0] <= hi).all()
