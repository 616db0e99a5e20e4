"""The BO family: iterations of ``bark_tpu_torch``'s BARK strategy.

Set-up makes the initial points from the seed, builds
``make_strategy("BARK")`` over its ``BARKSurrogate``, fits it (``tell``,
warm-up included) and runs one iteration to warm every shape. The unit is
one iteration as a user runs it: ``ask(1)``, the objective on the host,
``add`` (a warm-started refit). Every ``episode`` iterations the strategy is
put back to its state after the initial fit (device-side copies, the
generators seeded anew from the seed), so N stays in one padding bucket
and an iteration's cost does not drift over the window.

The check judges, for the asks it takes (all, or ``asks_checked`` drawn
from the seed): the acquisition values the search scored, at
``candidates_checked`` of its candidates drawn from the seed and at the
point it settled on (the centre of the best candidate's leaf box, against
the best value it returned), against the float64 reference over the same
posterior samples; that no checked candidate beats that point by more than
the acquisition's limit; that the returned point lies in the domain; and of
each refit, the samples' validity, that every chain moved, and one step
drawn from the seed, move by move (``lib/steps.py``): the scan's MLL
differences and decisions against the float64 replay of its m moves, and
the forests the step returned. An iteration whose ask recorded no scored
search counts as failed.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.data.tree_function import TreeFunction
from perfbench.lib import snapshot, steps
from perfbench.lib.seeds import derive, sync, worse
from perfbench.reference.forest import invalid_nodes
from perfbench.reference.gp import check_block, lcb
from perfbench.roofline.counts import dense_ask_flops, factored_ask_flops, step_flops, tier_of

KINDS = ("AcquisitionState", "AcquisitionStateLR")  # the LCB's states, dense and factored
CANDIDATES_CHECKED = 256  # candidates of each checked search, drawn from the seed
HOST_STEPS = 3  # the host's capture: the ask and this many steps of the refit


def _forest_dict(forest, rows=None) -> dict:
    return {k: (v if rows is None else v[rows]).cpu() for k, v in zip(forest._fields, forest)}


class _SearchRecorder:
    """Wraps the strategy's ``propose`` and the search's
    ``evaluate_acquisition`` in their modules, and keeps by reference, for
    each search, its acquisition's kind, every candidate batch it scored
    with the scores, and the point and value it returned."""

    def __init__(self):
        self.searches: list[dict] = []

    def install(self):
        from bark_tpu_torch.optimizer import search
        from bark_tpu_torch.strategies import tree_kernel

        propose, evaluate = tree_kernel.propose, search.evaluate_acquisition
        current: list[dict] = []

        def recorded_propose(draws, acq, *args, **kwargs):
            rec = {"kind": type(acq).__name__, "batches": []}
            current[:] = [rec]
            try:
                point, value = propose(draws, acq, *args, **kwargs)
            finally:
                current.clear()
            rec["point"], rec["value"] = np.asarray(point, np.float64), float(value)
            self.searches.append(rec)
            return point, value

        def recorded_evaluate(acq, batch, *args, **kwargs):
            scores = evaluate(acq, batch, *args, **kwargs)
            if current:
                current[0]["batches"].append((batch, scores))
            return scores

        self._saved = (tree_kernel, search, propose, evaluate)
        tree_kernel.propose, search.evaluate_acquisition = recorded_propose, recorded_evaluate

    def uninstall(self):
        tree_kernel, search, propose, evaluate = self._saved
        tree_kernel.propose, search.evaluate_acquisition = propose, evaluate

    def take(self) -> list[dict]:
        out, self.searches = self.searches, []
        return out


class Workload:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, device
        self.attempted = self.failed = 0
        self.iterations: list[dict] = []
        self.spans: dict[str, list[float]] | None = None

    # --- set-up -------------------------------------------------------
    def setup(self) -> None:
        from bark_tpu_torch.domain import CategoricalInput, ContinuousInput, Domain
        from bark_tpu_torch.fitting.params import SamplerParams
        from bark_tpu_torch.models.surrogate import BARKSurrogate
        from bark_tpu_torch.strategies.tree_kernel import make_strategy

        cfg, strat_cfg = self.config, self.config["strategy"]
        self.data = TreeFunction(**cfg["benchmark"])
        b = cfg["benchmark"]
        cats = tuple(chr(i + ord("a")) for i in range(b["num_cat"]))
        domain = Domain([*(ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(b["dim"])),
                         *(CategoricalInput(f"c_{i}", cats) for i in range(b["cat_dim"]))])
        self.params = SamplerParams(**cfg["sampler"])
        s = derive(self.seed, "strategy") % (1 << 31)
        surrogate = BARKSurrogate(domain, self.params, seed=s, device=self.device)
        self.strategy = make_strategy(
            strat_cfg["name"], domain, seed=s, surrogate=surrogate,
            num_candidates=strat_cfg["num_candidates"], num_rounds=strat_cfg["num_rounds"],
            acq_backend=strat_cfg["acq_backend"], kappa=strat_cfg["kappa"])
        n0 = self.traffic["n_init"]
        X0 = self.data.sample(n0, np.random.default_rng(derive(self.seed, "data")))
        self.strategy.tell(X0, self.data.f(X0))
        self.recorder = _SearchRecorder()
        self.recorder.install()
        self.steps = steps.StepRecorder().install()
        self.refit_steps = self.params.num_samples * self.params.steps_per_sample
        self.start = snapshot.take(self.strategy)
        self._iterate(keep=False)  # warms every shape of an iteration
        self._reset(0)
        self.episode = 0
        sync(self.device)

    def _reset(self, episode: int) -> None:
        t0 = time.perf_counter()
        snapshot.restore(self.strategy, self.start, derive(self.seed, "episode", episode))
        if self.spans is not None:
            sync(self.device)
            self.spans["reset_s"].append(time.perf_counter() - t0)

    def _iterate(self, keep: bool) -> None:
        strat, sur = self.strategy, self.strategy.surrogate
        X, y, model = strat.X, strat.y, sur.model
        fallbacks = strat.fallbacks
        t0 = time.perf_counter()
        cand = strat.ask(1)
        if self.spans is not None:
            sync(self.device)
            self.spans["ask_s"].append(time.perf_counter() - t0)
        y_new = self.data.f(cand)
        if keep:
            i = len(self.iterations)
            rng = np.random.default_rng(derive(self.seed, "scan", i))
            self.steps.arm(int(rng.integers(self.refit_steps)))
        t0 = time.perf_counter()
        strat.add(cand, y_new)
        if self.spans is not None:
            sync(self.device)
            self.spans["fit_s"].append(time.perf_counter() - t0)
        searches = self.recorder.take()
        step = self.steps.take()
        if keep:
            self.iterations.append({
                "X": X, "y": y, "before": model, "after": sur.model, "point": cand[0],
                "fit_X": strat.X, "fit_y": strat.y, "step": step,
                "searches": searches, "fell_back": strat.fallbacks != fallbacks,
            })

    # --- the window -----------------------------------------------------
    def unit(self) -> None:
        i = self.attempted
        if i and i % self.traffic["episode"] == 0:
            self.episode += 1
            self._reset(self.episode)
        self.attempted += 1
        self._iterate(keep=True)
        it = self.iterations[-1]
        scored = any(s["batches"] for s in it["searches"] if s["kind"] in KINDS)
        if it["fell_back"] or not scored:
            self.failed += 1

    def end_to_end(self, seconds: float) -> dict:
        return {"bo_iter_s": (seconds / max(self.attempted, 1), "s")}

    # --- the traced run ---------------------------------------------------
    def traced(self, trace) -> dict:
        """Profile one more iteration (in the episode the window left off),
        the device's activity alone; then capture the ask and the first
        ``HOST_STEPS`` steps of the refit of the next with the host's
        operations, for the breakdown (the host's events of a whole
        iteration take minutes to read)."""
        prof = trace.profile(lambda: self._iterate(keep=False))
        host = trace.host_capture(lambda: self._iterate(keep=False),
                                  lambda stop: self.steps.after_steps(HOST_STEPS, stop))
        return {"trace": prof, "host_trace": host}

    def spans_on(self) -> None:
        """Time ask and add, each closed by a synchronisation (traced runs)."""
        self.spans = {"ask_s": [], "fit_s": [], "reset_s": []}

    def layer_context(self, seconds: float) -> dict:
        """The work of an iteration: the refit's chain-steps and the asks'
        builds and scoring, at the window's sizes and leaves in use."""
        cfg = self.config
        m, chains = self.params.num_trees, self.params.num_chains
        steps = self.params.num_samples * self.params.steps_per_sample
        total = 0.0
        for it in self.iterations:
            n = len(it["y"])
            forest = it["after"].forest
            leaves = float((forest.is_leaf & forest.active).sum((-2, -1)).double().mean())
            total += chains * steps * step_flops(tier_of(n + 1), n + 1, m, leaves)
            samples = it["before"].noise.numel()
            cands = cfg["strategy"]["num_candidates"] * (1 + cfg["strategy"]["num_rounds"])
            for s in it["searches"]:
                if s["kind"] == "AcquisitionState":
                    total += dense_ask_flops(samples, n, m, cands)
                elif s["kind"] == "AcquisitionStateLR":
                    total += factored_ask_flops(samples, n, leaves, cands)
        out = {"flops_per_iteration": total / max(len(self.iterations), 1),
               "bo_iter_s": self.end_to_end(seconds)["bo_iter_s"][0]}
        if self.spans is not None:
            out["spans"] = {k: list(v) for k, v in self.spans.items()}
            resets = out["spans"]["reset_s"]
            print(f"[perfbench] {len(resets)} episode resets, {sum(resets):.4f} s of the "
                  f"{seconds:.1f}-s window", file=sys.stderr)
        return out

    # --- the check --------------------------------------------------------
    def release(self) -> None:
        """Keep on the host what the check judges, for the asks it takes;
        free the device."""
        self.recorder.uninstall()
        self.steps.uninstall()
        taken = range(len(self.iterations))
        k = self.traffic["asks_checked"]
        if k and k < len(self.iterations):
            rng = np.random.default_rng(derive(self.seed, "asks"))
            taken = sorted(rng.choice(len(self.iterations), k, replace=False))
        self.claims = []
        for i, it in enumerate(self.iterations):
            claim = {"point": it["point"], "fit": {
                "forest": _forest_dict(it["after"].forest),
                "noise": it["after"].noise.cpu(),
                "start": _forest_dict(it["before"].forest, (slice(None), -1)),
                "start_noise": it["before"].noise[:, -1].cpu(),
                "X": it["fit_X"], "y": it["fit_y"], "step": steps.on_host(it["step"])}}
            if i in taken:
                searches = []
                for s in it["searches"]:
                    if s["kind"] not in KINDS:
                        continue  # a Thompson draw's search: not a mean and variance
                    searches.append({
                        "candidates": torch.cat([b for b, _ in s["batches"]]).cpu(),
                        "scores": torch.cat([v for _, v in s["batches"]]).cpu(),
                        "point": s["point"], "value": s["value"]})
                before = it["before"]
                claim.update({"X": it["X"], "y": it["y"], "searches": searches,
                              "model": {"forest": _forest_dict(before.forest),
                                        "noise": before.noise.cpu(),
                                        "scale": before.scale.cpu()}})
            self.claims.append(claim)
        del self.iterations, self.strategy, self.start

    def readings(self, claim: dict, device, precision: str = "program") -> dict:
        """The numbers compared for one iteration. ``precision`` "program"
        judges the program's scores; "tf32" judges the control: the
        reference computed in TF32 from the same samples in the program's
        place."""
        data, cfg = self.data, self.config
        bounds = torch.as_tensor(data.bounds("ordinal"), dtype=torch.float64)
        ft = torch.as_tensor(data.feature_types(), device=device)
        point = torch.as_tensor(np.asarray(claim["point"], np.float64))
        fit = claim["fit"]
        flat = lambda f: {k: v.reshape(-1, *v.shape[-2:]).to(device) for k, v in f.items()}  # noqa: E731
        out = {
            "outside": int(((point < bounds[:, 0]) | (point > bounds[:, 1])).sum()),
            "bad_nodes": int(invalid_nodes(flat(fit["forest"]), bounds.float().to(device),
                                           ft).sum()),
            "unmoved_chains": self._unmoved(fit),
        }
        if fit["step"] is not None:
            out.update(steps.readings(
                fit["step"], torch.as_tensor(fit["X"], device=device),
                self._standard(fit["y"], device), ft, cfg["sampler"]["num_trees"],
                cfg["jitter"], self.limits["accept_gap"], precision,
                check_block(len(fit["y"]))))
        if "searches" not in claim:
            return out
        y_std = self._standard(claim["y"], device)
        X = torch.as_tensor(claim["X"], device=device)
        model = claim["model"]
        forest = flat(model["forest"])
        noise = model["noise"].reshape(-1).to(device)
        scale = model["scale"].reshape(-1).to(device)
        args = (forest, noise, scale, X, y_std)
        rest = dict(feat_types=ft, jitter=cfg["jitter"], kappa=cfg["strategy"]["kappa"],
                    block=check_block(len(claim["y"])))
        margin = self.limits["acq_gap"]
        gaps, better = [], 0
        for j, s in enumerate(claim["searches"]):
            rng = np.random.default_rng(derive(self.seed, "candidates", j, len(claim["y"])))
            count = s["scores"].shape[0]
            idx = rng.choice(count, min(CANDIDATES_CHECKED, count), replace=False)
            idx = np.union1d(idx, [int(torch.argmin(s["scores"]))])
            pts = torch.cat([s["candidates"][idx].double(),
                             torch.as_tensor(s["point"])[None]]).to(device)
            ref = lcb(*args, pts, **rest)
            if precision == "program":  # at the point: the value the search returned
                got = torch.cat([s["scores"][idx].double(),
                                 torch.tensor([s["value"]], dtype=torch.float64)]).to(device)
            else:
                got = lcb(*args, pts, **rest, precision=precision).double()
            gaps.append(float((got - ref).abs().max()))
            better += int((ref[:-1] < ref[-1] - margin).sum())
        if gaps:
            out["acq_gap"] = max(gaps)
            out["better_than_point"] = better
        return out

    @staticmethod
    def _standard(y, device) -> torch.Tensor:
        """The standardized target, as the surrogate fits it."""
        y = np.asarray(y, np.float64)
        return torch.as_tensor((y - y.mean()) / max(y.std(), 1e-6), device=device)

    def _unmoved(self, fit) -> int:
        same = torch.ones_like(fit["start_noise"], dtype=torch.bool)
        for k, v in fit["forest"].items():
            same &= (v[:, -1] == fit["start"][k]).flatten(1).all(1)
        return int((same & (fit["noise"][:, -1] == fit["start_noise"])).sum())

    def check(self, device) -> list[dict]:
        worst: dict[str, float] = {}
        for claim in self.claims:
            got = {k: v for k, v in self.readings(claim, device).items() if k in self.limits}
            if not all(v <= self.limits[k] for k, v in got.items()):
                self.failed += 1
            for k, v in got.items():
                worst[k] = worse(v, worst.get(k))
        return [{"name": k, "value": v, "limit": self.limits[k]} for k, v in worst.items()]
