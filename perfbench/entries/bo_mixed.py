"""The BO family on a domain of categorical inputs (PestControl).

``entries/bo.py``'s unit, episodes, traced part and check, with:

- the domain and data of the config's benchmark (``data/pest.py``): 25
  categorical inputs of 5 levels; the objective's generator is seeded from
  the run's seed at set-up and anew at every episode reset, so that an
  episode's objective values repeat;
- the forests' validity (``bad_nodes``) judged by ``reference/validity.py``,
  a categorical split's threshold a bitmask;
- ``outside`` also counting a categorical coordinate that is not a whole
  level in [0, k - 1];
- every Thompson search an ask ran (the duplicate retry of
  ``TreeKernelStrategy.ask``) judged against ``reference/thompson.py`` on
  the same posterior sample and normal vector: ``ts_gap``, the largest gap
  between the program's scores and the reference's at the checked
  candidates and at the point. When the window ran none, the entry runs one
  itself after the window, before the strategy is freed: through the
  program's own ``draw_acquisition_ts``, ``build_acquisition_ts`` and
  ``propose`` on the last iteration's posterior, from generators seeded by
  the run's seed, and judges that one (the traffic checks every ask);
- ``better_than_point`` over both kinds of search;
- an iteration failed whose ask fell back or answered at random (the
  strategy's ``random_asks`` moved);
- the strategy's ``duplicate_asks`` and ``random_asks`` over the window's
  asks handed to the metric readers, read with ``getattr(..., None)``, so a
  program without them runs the cell and those metrics read None.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data.pest import FEAT_CAT, PestControl
from perfbench.entries.bo import CANDIDATES_CHECKED, Workload as BOWorkload
from perfbench.entries.bo import _SearchRecorder
from perfbench.lib import snapshot, steps
from perfbench.lib.seeds import derive, sync
from perfbench.reference import thompson
from perfbench.reference.validity import invalid_nodes
from perfbench.roofline.thompson import thompson_ask_flops

TS = "AcquisitionStateTS"  # the Thompson draw's acquisition state
COUNTERS = ("duplicate_asks", "random_asks")


class _Recorder(_SearchRecorder):
    """``bo``'s search recorder, and for each Thompson search the draw it
    was built from: the posterior sample picked and the normal vector
    (``tree_kernel.draw_acquisition_ts``, wrapped in its module)."""

    def install(self):
        super().install()
        from bark_tpu_torch.strategies import tree_kernel

        draw, propose = tree_kernel.draw_acquisition_ts, tree_kernel.propose
        drawn: list[tuple] = []

        def recorded_draw(*args, **kwargs):
            pick, eps = draw(*args, **kwargs)
            drawn[:] = [(pick, eps)]
            return pick, eps

        def recorded_propose(draws, acq, *args, **kwargs):
            out = propose(draws, acq, *args, **kwargs)  # bo's wrapper: the search is recorded
            if type(acq).__name__ == TS and drawn:
                self.searches[-1]["pick"], self.searches[-1]["eps"] = drawn.pop()
            return out

        self._ts_saved = (tree_kernel, draw, propose)
        tree_kernel.draw_acquisition_ts, tree_kernel.propose = recorded_draw, recorded_propose

    def uninstall(self):
        tree_kernel, draw, propose = self._ts_saved
        tree_kernel.draw_acquisition_ts, tree_kernel.propose = draw, propose
        super().uninstall()


def outside(point: torch.Tensor, bounds: torch.Tensor, feat_types: torch.Tensor) -> int:
    """Coordinates outside the ordinal bounds ``(D, 2)``, or categorical and
    not a whole level."""
    bad = (point < bounds[:, 0]) | (point > bounds[:, 1])
    bad |= (feat_types.to(point.device) == FEAT_CAT) & (point != torch.round(point))
    return int(bad.sum())


class Workload(BOWorkload):
    # --- set-up -------------------------------------------------------
    def setup(self) -> None:
        from bark_tpu_torch.domain import CategoricalInput, Domain
        from bark_tpu_torch.fitting.params import SamplerParams
        from bark_tpu_torch.models.surrogate import BARKSurrogate
        from bark_tpu_torch.strategies.tree_kernel import make_strategy

        from perfbench.data.pest import CATEGORIES

        cfg, strat_cfg = self.config, self.config["strategy"]
        self.data = PestControl(**cfg["benchmark"], seed=derive(self.seed, "objective"))
        domain = Domain([CategoricalInput(f"stage_{i + 1}", CATEGORIES)
                         for i in range(self.data.n_stages)])
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
        self.recorder = _Recorder()
        self.recorder.install()
        self.steps = steps.StepRecorder().install()
        self.refit_steps = self.params.num_samples * self.params.steps_per_sample
        self.start = snapshot.take(self.strategy)
        self._iterate(keep=False)  # warms every shape of an iteration
        self._reset(0)
        self.episode = 0
        sync(self.device)

    def _reset(self, episode: int) -> None:
        super()._reset(episode)
        self.data.reseed(derive(self.seed, "objective", episode))

    def _iterate(self, keep: bool) -> None:
        """``bo``'s iteration, with the moves of the strategy's counters in
        its ask (None where the program has no such counter)."""
        strat = self.strategy
        before = [getattr(strat, k, None) for k in COUNTERS]
        super()._iterate(keep)
        if keep:
            it = self.iterations[-1]
            for k, b in zip(COUNTERS, before):
                a = getattr(strat, k, None)
                it[k] = None if a is None or b is None else a - b

    # --- the window -----------------------------------------------------
    def unit(self) -> None:
        failed = self.failed
        super().unit()
        if self.failed == failed and self.iterations[-1]["random_asks"]:
            self.failed += 1

    # --- the traced run ---------------------------------------------------
    def layer_context(self, seconds: float) -> dict:
        """``bo``'s, with the Thompson searches' work added to an
        iteration's, and the counters' moves over the window's asks."""
        out = super().layer_context(seconds)
        strat_cfg = self.config["strategy"]
        cands = strat_cfg["num_candidates"] * (1 + strat_cfg["num_rounds"])
        extra = 0.0
        for it in self.iterations:
            for s in it["searches"]:
                if s["kind"] == TS:
                    extra += thompson_ask_flops(len(it["y"]), self._leaves(it, s["pick"]), cands)
        out["flops_per_iteration"] += extra / max(len(self.iterations), 1)
        out["asks"] = len(self.iterations)
        for k in COUNTERS:
            moves = [it[k] for it in self.iterations]
            out[k] = None if any(v is None for v in moves) else sum(moves)
        return out

    @staticmethod
    def _leaves(it: dict, pick: int) -> float:
        """Leaves in use in the posterior sample ``pick`` of the iteration's
        ask."""
        f = it["before"].forest
        leaf = (f.is_leaf & f.active).reshape(-1, *f.is_leaf.shape[-2:])[pick]
        return float(leaf.sum())

    # --- the check --------------------------------------------------------
    def _own_thompson(self, it: dict) -> None:
        """One Thompson search on the posterior of ``it``'s ask, through the
        program's own build and search, recorded as the window's are."""
        strat, sur = self.strategy, self.strategy.surrogate
        sur.model = it["before"]
        sur._store_train_data(it["X"], it["y"])
        strat._generator.manual_seed(derive(self.seed, "thompson"))
        strat._rng = np.random.default_rng(derive(self.seed, "thompson"))
        strat._propose_once(use_ts=True)
        it["searches"] += self.recorder.take()

    def release(self) -> None:
        """``bo``'s, and on the host each checked ask's Thompson searches
        with their draws; one made here where the window made none."""
        its = self.iterations
        if its and not any(s["kind"] == TS for it in its for s in it["searches"]):
            self._own_thompson(its[-1])
        kept = [[{"candidates": torch.cat([b for b, _ in s["batches"]]).cpu(),
                  "scores": torch.cat([v for _, v in s["batches"]]).cpu(),
                  "point": s["point"], "value": s["value"],
                  "pick": s["pick"], "eps": s["eps"].cpu()}
                 for s in it["searches"] if s["kind"] == TS and s["batches"]] for it in its]
        super().release()
        for claim, searches in zip(self.claims, kept):
            if "searches" in claim:  # an ask the check takes
                claim["thompson"] = searches

    def readings(self, claim: dict, device, precision: str = "program") -> dict:
        """``bo``'s numbers, with ``bad_nodes`` and ``outside`` judged as
        above, and of the Thompson searches ``ts_gap`` and their part of
        ``better_than_point``."""
        out = super().readings(claim, device, precision)
        data = self.data
        bounds = torch.as_tensor(data.bounds("ordinal"), dtype=torch.float64)
        ft = torch.as_tensor(data.feature_types(), device=device)
        point = torch.as_tensor(np.asarray(claim["point"], np.float64))
        out["outside"] = outside(point, bounds, ft.cpu())
        flat = lambda f: {k: v.reshape(-1, *v.shape[-2:]).to(device) for k, v in f.items()}  # noqa: E731
        out["bad_nodes"] = int(invalid_nodes(flat(claim["fit"]["forest"]),
                                             bounds.float().to(device), ft).sum())
        if not claim.get("thompson"):
            return out
        y_std = self._standard(claim["y"], device)
        X = torch.as_tensor(claim["X"], device=device)
        model = claim["model"]
        forest = flat(model["forest"])
        noise = model["noise"].reshape(-1)
        scale = model["scale"].reshape(-1)
        jitter, margin = self.config["jitter"], self.limits["ts_gap"]
        gaps, better = [], 0
        for j, s in enumerate(claim["thompson"]):
            rng = np.random.default_rng(derive(self.seed, "ts-candidates", j, len(claim["y"])))
            count = s["scores"].shape[0]
            idx = rng.choice(count, min(CANDIDATES_CHECKED, count), replace=False)
            idx = np.union1d(idx, [int(torch.argmin(s["scores"]))])
            pts = torch.cat([s["candidates"][idx].double(),
                             torch.as_tensor(s["point"])[None]]).to(device)
            pick = s["pick"]
            args = ({k: v[pick] for k, v in forest.items()}, float(noise[pick]),
                    float(scale[pick]), X, y_std, s["eps"].to(device), pts, ft, jitter)
            ref = thompson.scores(*args)
            if precision == "program":  # at the point: the value the search returned
                got = torch.cat([s["scores"][idx].double(),
                                 torch.tensor([s["value"]], dtype=torch.float64)]).to(device)
            else:
                got = thompson.scores(*args, precision=precision).double()
            gaps.append(float((got - ref).abs().max()))
            better += int((ref[:-1] < ref[-1] - margin).sum())
        out["ts_gap"] = max(gaps)
        out["better_than_point"] = out.get("better_than_point", 0) + better
        return out
