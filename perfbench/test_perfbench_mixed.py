"""The categorical cell and its check of forests, on the CPU at a tiny size
(and one short run of the cell on the card, marked ``cuda``).

``reference/validity.py`` judges a categorical split's threshold as a
bitmask over the categories that reach its node; ``entries/mcmc_mixed.py``
runs the sampler family with that check. Run with

    python -m pytest perfbench -q -o addopts="" -p no:cacheprovider
"""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from perfbench.data import tree_function as frozen
from perfbench.data.tree_function import TreeFunction
from perfbench.lib import registry, tiny
from perfbench.reference import forest as ref_forest
from perfbench.reference import validity
from perfbench.test_perfbench_harness import (
    KEYS,
    _accept_by_prior_alone,
    _altered_mll,
    _bf16_scan,
    _half_batch_mcmc,
    _merge_every_proposal,
    _step_unchanged,
    one_run,
)

CPU = torch.device("cpu")
CELL = "mcmc.treefn5.n50.cat2"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


# --- the check of forests, on hand-built trees ---------------------------------

# input 1 of ``MIXED`` is categorical with 5 levels, so the set at the root
# is 31; a spec is ("split", feature, threshold, left, right)
MIXED = torch.tensor([2, 0], dtype=torch.int32)
MIXED_BOUNDS = torch.tensor([[0.0, 1.0], [0.0, 4.0]])  # ordinal
LEAF = ("leaf",)


def root_split(mask):
    return ("split", 1, mask, LEAF, LEAF)


def under(side, root_mask, mask, via_numeric=False):
    """A split on input 1 with ``mask`` under the root's split on input 1
    (``root_mask``), on its ``side``; ``via_numeric`` puts a split on input 0
    between them."""
    inner = ("split", 1, mask, LEAF, LEAF)
    if via_numeric:
        inner = ("split", 0, 0.5, inner, LEAF)
    kids = (inner, LEAF) if side == "left" else (LEAF, inner)
    return ("split", 1, root_mask, *kids)


CATEGORICAL_CASES = [
    # valid: masks above k - 1 at the root, proper subsets under an ancestor
    (root_split(6), 0), (root_split(30), 0), (root_split(1), 0),
    (under("left", 6, 2), 0), (under("left", 6, 4), 0),
    (under("right", 6, 1), 0), (under("right", 6, 24), 0),
    (under("left", 6, 2, via_numeric=True), 0),
    # bad: empty, not an integer, the whole set that reaches the node, a bit
    # of a category that the ancestor sent the other way, outside the levels
    (root_split(0), 1), (root_split(2.5), 1), (root_split(31), 1), (root_split(32), 1),
    (root_split(-2), 1), (under("left", 6, 0), 1), (under("left", 6, 6), 1),
    (under("left", 6, 8), 1), (under("left", 6, 10), 1), (under("right", 6, 2), 1),
    (under("right", 6, 25), 1), (under("left", 6, 8, via_numeric=True), 1),
    (under("left", 6, 6, via_numeric=True), 1),
]


def fields(spec):
    return {k: torch.as_tensor(v)[None, None] for k, v in
            frozen.build_tree_arrays(spec, node_limit=8).items()}


@pytest.mark.parametrize("spec,want", CATEGORICAL_CASES,
                         ids=[str(i) for i in range(len(CATEGORICAL_CASES))])
def test_categorical_masks_are_judged_as_bitmasks(spec, want):
    assert validity.invalid_nodes(fields(spec), MIXED_BOUNDS, MIXED).tolist() == [want]


def test_the_ordinal_check_misjudges_categorical_masks():
    """``forest.invalid_nodes``, which the continuous cells keep, holds a
    mask to [0, k - 1]: it calls valid masks bad and lets faults pass, so it
    cannot judge a categorical cell."""
    cases = [(root_split(6), 1, 0), (root_split(30), 1, 0),  # valid, called bad
             (root_split(0), 0, 1), (under("left", 2, 1), 0, 1)]  # faults, let pass
    for spec, ordinal, bitmask in cases:
        f = fields(spec)
        assert ref_forest.invalid_nodes(f, MIXED_BOUNDS, MIXED).tolist() == [ordinal]
        assert validity.invalid_nodes(f, MIXED_BOUNDS, MIXED).tolist() == [bitmask]


def test_validity_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.validity; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bark_tpu', 'bark_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(registry.BENCH_DIR.parent), check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# --- the kept forests of the tiny copies ----------------------------------------


def kept_forests(bench, cell, seed=2**34 + 5):
    """(forests ``(C, m, node_limit)``, ordinal bounds, feature types) of
    every call or refit that the tiny copy of ``cell`` keeps for its check."""
    c = registry.load_cell(cell, bench)
    work = c.entry.Workload(c.config, c.traffic, c.limits, seed, CPU)
    work.setup()
    for _ in range(3):
        work.unit()
    work.release()
    data = TreeFunction(**c.config["benchmark"])
    bounds = torch.as_tensor(data.bounds("ordinal"))
    ft = torch.as_tensor(data.feature_types())
    flat = lambda f: {k: v.reshape(-1, *v.shape[-2:]) for k, v in f.items()}  # noqa: E731
    return [(flat(claim["fit"]["forest"] if "fit" in claim else claim["forest"]), bounds, ft)
            for claim in work.claims]


def test_the_categorical_cell_keeps_categorical_splits(bench):
    """The tiny copy of the categorical cell keeps forests that split on its
    categorical inputs, some under an ancestor's split on the same input;
    the bitmask check finds none of them bad, the ordinal one many."""
    kept = kept_forests(bench, CELL)
    cat_splits = nested = ordinal_bad = 0
    for f, bounds, ft in kept:
        split = f["active"] & ~f["is_leaf"]
        on_cat = split & (ft[f["feature"].long()] == ref_forest.FEAT_CAT)
        cat_splits += int(on_cat.sum())
        parent = f["parent"].long()
        same = torch.gather(f["feature"], 2, parent) == f["feature"]
        nested += int((on_cat & same & (torch.arange(split.shape[-1]) > 0)
                       & torch.gather(split, 2, parent)).sum())
        assert validity.invalid_nodes(f, bounds, ft).sum() == 0
        ordinal_bad += int(ref_forest.invalid_nodes(f, bounds, ft).sum())
    assert cat_splits > 0 and nested > 0, (cat_splits, nested)
    assert ordinal_bad > 0


def _broken(forest, gen):
    """The forest with faults planted at random nodes: thresholds moved,
    nodes switched on or off, depths and children changed."""
    f = {k: v.clone() for k, v in forest.items()}
    pick = lambda p: torch.rand(f["active"].shape, generator=gen) < p  # noqa: E731
    f["threshold"] = torch.where(pick(0.1), f["threshold"] + torch.rand(
        f["threshold"].shape, generator=gen) * 2 - 0.5, f["threshold"])
    f["active"] = f["active"] ^ pick(0.02)
    f["depth"] = torch.where(pick(0.02), f["depth"] + 1, f["depth"])
    f["left"] = torch.where(pick(0.02), f["right"], f["left"])
    return f


@pytest.mark.parametrize("cell", ["mcmc.treefn5.n50", "bo.treefn5.n50"])
def test_forests_with_no_categorical_split_read_the_same_under_both_checks(bench, cell):
    """On the continuous cells' kept forests, whole and with faults planted,
    the bitmask check counts exactly what the ordinal one counts."""
    gen = torch.Generator().manual_seed(7)
    planted = 0
    for f, bounds, ft in kept_forests(bench, cell):
        for g in [f] + [_broken(f, gen) for _ in range(4)]:
            got = validity.invalid_nodes(g, bounds.float(), ft)
            assert torch.equal(got, ref_forest.invalid_nodes(g, bounds.float(), ft))
            planted += int(got.sum())
    assert planted > 0


# --- the cell, run whole ----------------------------------------------------------


def test_result_line(bench):
    import json

    result = one_run(bench, CELL)
    assert list(result) == KEYS
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if registry.reports(m, CELL, spec["end_to_end"])}
    assert set(result["metrics"]) == want
    limits = json.loads((bench / "limits" / f"{CELL}.json").read_text())
    assert set(result["compared"]) == set(limits)


def _whole_set_categorical_split(monkeypatch):
    """A categorical split draws the whole set of categories that reach its
    node, so every row goes left."""
    from bark_tpu_torch.fitting import proposals

    real = proposals._sample_split_from_bounds

    def draw(noise, lb, ub, ftype):
        return torch.where(ftype == proposals.FEAT_CAT, ub, real(noise, lb, ub, ftype))

    monkeypatch.setattr(proposals, "_sample_split_from_bounds", draw)


FAULTS = [
    (_step_unchanged, "unmoved_chains"),
    (_accept_by_prior_alone, "accept_gap"),
    (_bf16_scan, "accept_gap"),
    (_merge_every_proposal, "merge_mismatch"),
    (_half_batch_mcmc, "unmoved_chains"),
    (_altered_mll, "mll_gap"),
    (_whole_set_categorical_split, "bad_nodes"),
]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f.__name__.strip("_") for f, _ in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(bench, monkeypatch, fault, number):
    fault(monkeypatch)
    result = one_run(bench, CELL)
    assert result["correct"] is False
    got = result["compared"][number]
    assert not got["value"] <= got["limit"]


def test_the_control_is_not_correct(bench):
    """The reference computed in TF32 in the program's place fails a limit
    that the program's own outputs meet."""
    c = registry.load_cell(CELL, bench)
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
        assert result["device"]["busy_s"] > 0 and result["metrics"]
