"""The sampler family: forest-MCMC calls of ``bark_tpu_torch``.

Set-up makes the data from the seed, runs one call from empty forests and
one more from its last sample (the warm state, as root ``bench.py``). The
unit is one call of the sampler (``fitting/sampler.run_chain``, which
``run_bark_sampler`` wraps, so that the carried state can be judged) from
the warm state with a new generator drawn from the seed, the calls back to
back. The check judges the state a call returns against the float64
reference: the leaves of X in the returned forests, K^-1 where the tier
carries it, log det K and the MLL at the returned forest, noise and scale,
the forests' validity, and that every chain moved. In the call drawn from
the seed it also judges one step drawn from the seed, move by move
(``lib/steps.py``): the scan's MLL differences and decisions against the
float64 replay of its m moves, and the forests the step returned.

The protocol is fixed here, not in the traffic: two untimed calls in
set-up, the call checked drawn from the window's first four, five steps
profiled in the traced run.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data.tree_function import TreeFunction
from perfbench.lib import steps
from perfbench.lib.seeds import derive, sync, worse
from perfbench.reference.forest import invalid_nodes
from perfbench.reference.gp import chain_state, check_block
from perfbench.roofline.counts import step_flops, tier_of

WARM_CALLS = 2  # set-up: one call from empty forests, one from its last sample
FIRST_CALLS = 4  # the call checked is drawn from the window's first four
PROFILE_STEPS = 5  # the traced run profiles a call of this many steps


def _forest_dict(forest) -> dict:
    return {k: getattr(forest, k) for k in forest._fields}


class Workload:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, device
        self.attempted = self.failed = 0
        self.kept: dict[int, object] = {}

    # --- set-up -------------------------------------------------------
    def setup(self) -> None:
        from bark_tpu_torch.fitting.params import SamplerParams
        from bark_tpu_torch.fitting.sampler import BARKModel, run_chain
        from bark_tpu_torch.forest import Forest, create_empty_forest

        self._run_chain = run_chain
        cfg, dev = self.config, self.device
        data = TreeFunction(**cfg["benchmark"])
        n = self.traffic["n_train"]
        X = data.sample(n, np.random.default_rng(derive(self.seed, "data")))
        y = data.f(X)
        self.y_std = (y - y.mean()) / y.std()
        self.X_host = X
        self.params = SamplerParams(**cfg["sampler"])
        self.X = torch.as_tensor(X, device=dev)
        self.y = torch.as_tensor(self.y_std, dtype=torch.float32, device=dev)
        self.bounds = torch.as_tensor(data.bounds("bitmask"), device=dev)
        self.ft = torch.as_tensor(data.feature_types(), device=dev)
        self.ord_bounds = torch.as_tensor(data.bounds("ordinal"))
        c = self.params.num_chains
        empty = BARKModel(
            create_empty_forest(self.params.num_trees, self.params.node_limit, (c,), dev),
            torch.full((c,), 0.1, dtype=torch.float32, device=dev),
            torch.ones((c,), dtype=torch.float32, device=dev),
        )
        run = self._call(empty, derive(self.seed, "warm", 0))
        last = lambda t: t[:, -1]  # noqa: E731
        self.warm = BARKModel(Forest(*(last(f) for f in run.samples.forest)),
                              last(run.samples.noise), last(run.samples.scale))
        for i in range(1, WARM_CALLS):
            self._call(self.warm, derive(self.seed, "warm", i))
        sync(dev)
        self.steps_per_call = self.params.num_samples * self.params.steps_per_sample
        rng = np.random.default_rng(derive(self.seed, "check"))
        self.check_at = int(rng.integers(FIRST_CALLS))
        self.min_units = self.check_at + 1
        self.check_step = int(rng.integers(self.steps_per_call))
        self.recorder = steps.StepRecorder().install()
        self.step_kept = None

    def _call(self, model, seed: int, params=None):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._run_chain(gen, model, self.X, self.y, self.bounds, self.ft,
                               params or self.params)

    # --- the window -----------------------------------------------------
    def unit(self) -> None:
        i = self.attempted
        self.attempted += 1
        if i == self.check_at:
            self.recorder.arm(self.check_step)
        run = self._call(self.warm, derive(self.seed, "call", i))
        if i == self.check_at:
            self.step_kept = self.recorder.take()
        self.kept = {k: v for k, v in self.kept.items() if k == self.check_at}
        self.kept[i] = run

    def end_to_end(self, seconds: float) -> dict:
        steps = self.attempted * self.params.num_chains * self.steps_per_call
        return {"mcmc_steps_per_s": (steps / seconds, "steps/s")}

    # --- the traced run ---------------------------------------------------
    def traced(self, trace) -> dict:
        """Profile a call of ``PROFILE_STEPS`` steps from the warm state,
        the device's activity alone, then the same call again with the
        host's operations for the breakdown; count the host's
        synchronisations in a whole call."""
        short = self.params.with_(num_samples=1, steps_per_sample=PROFILE_STEPS)
        part = lambda: self._call(self.warm, derive(self.seed, "profile"), short)  # noqa: E731
        prof = trace.profile(part)
        host = trace.host_capture(part)
        syncs = trace.count_syncs(lambda: self._call(self.warm, derive(self.seed, "syncs")))
        return {"trace": prof, "host_trace": host, "profiled_steps": PROFILE_STEPS,
                "host_syncs_per_step": syncs / self.steps_per_call}

    def layer_context(self, seconds: float) -> dict:
        """What the per-layer readers need beside the trace: the work of a
        chain-step at the leaves the kept state holds, and the window's rate."""
        run = self.kept[max(self.kept)]
        forest = run.state.forest
        leaves = float((forest.is_leaf & forest.active).sum((-2, -1)).double().mean())
        n = self.traffic["n_train"]
        flops = step_flops(tier_of(n), n, self.params.num_trees, leaves)
        return {"flops_per_step": flops, "leaves_in_use": leaves,
                "steps_per_s": self.end_to_end(seconds)["mcmc_steps_per_s"][0]}

    # --- the check --------------------------------------------------------
    def release(self) -> None:
        """Keep on the host what the check judges; free the device."""
        self.recorder.uninstall()
        self.claims = []
        for i, run in sorted(self.kept.items()):
            s = run.state
            self.claims.append({
                "call": i,
                "forest": {k: v[:, -1].cpu() for k, v in _forest_dict(run.samples.forest).items()},
                "noise": run.samples.noise[:, -1].cpu(), "scale": run.samples.scale[:, -1].cpu(),
                "leaves": s.leaves.cpu(), "mll": s.mll.cpu(), "logdet": s.kern.K_logdet.cpu(),
                "kinv": None if s.kern.K_inv is None else s.kern.K_inv.cpu(),
                "step": steps.on_host(self.step_kept) if i == self.check_at else None,
            })
        self.warm_host = ({k: v.cpu() for k, v in _forest_dict(self.warm.forest).items()},
                          self.warm.noise.cpu())
        del self.kept, self.warm, self.X, self.y, self.step_kept

    def readings(self, claim: dict, device, precision: str = "program") -> dict:
        """The numbers compared for one kept call. ``precision`` "program"
        judges the program's state; "tf32" judges the control, the reference
        computed in TF32 from the same returned forests in the program's
        place."""
        cfg = self.config
        block = check_block(self.traffic["n_train"])
        to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        forest = to(claim["forest"])
        X = torch.as_tensor(self.X_host, device=device)
        y = torch.as_tensor(self.y_std, device=device)
        ft = self.ft.to(device)
        args = (forest, claim["noise"].to(device), claim["scale"].to(device), X, y, ft,
                cfg["sampler"]["num_trees"], cfg["jitter"])
        if precision == "program":
            got = {k: claim[k] for k in ("leaves", "mll", "logdet", "kinv")}
        else:
            ctl = chain_state(*args, precision=precision, block=block,
                              keep_kinv=claim["kinv"] is not None)
            got = {"leaves": ctl["leaves"], "mll": ctl["mll"], "logdet": ctl["logdet"],
                   "kinv": ctl["K_inv"] if claim["kinv"] is not None else None}
        ref = chain_state(*args, block=block, kinv_claim=None if got["kinv"] is None
                          else got["kinv"].to(device))
        n = X.shape[0]
        dmll = (got["mll"].to(device, torch.float64) - ref["mll"]).abs()
        scale = ref["quad"].abs() + ref["logdet"].abs()
        out = {
            "leaf_mismatch": int((got["leaves"].to(device).long() != ref["leaves"]).sum()),
            "bad_nodes": int(invalid_nodes(forest, self.ord_bounds.to(device), ft).sum()),
            "unmoved_chains": self._unmoved(claim),
            "mll_gap": float(torch.max(dmll / scale)),
            "logdet_gap": float(torch.max(
                (got["logdet"].to(device, torch.float64) - ref["logdet"]).abs()) / n),
        }
        if got["kinv"] is not None:
            out["kinv_gap"] = float(torch.max(ref["kinv_gap"]))
        if claim["step"] is not None:
            out.update(steps.readings(claim["step"], X, y, ft, cfg["sampler"]["num_trees"],
                                      cfg["jitter"], self.limits["accept_gap"], precision,
                                      block))
        return out

    def _unmoved(self, claim) -> int:
        forest0, noise0 = self.warm_host
        same = torch.ones_like(noise0, dtype=torch.bool)
        for k, v in claim["forest"].items():
            same &= (v == forest0[k]).flatten(1).all(1)
        return int((same & (claim["noise"] == noise0)).sum())

    def check(self, device) -> list[dict]:
        """Each kept call's numbers that the cell's limits list, at their
        worst; a call that fails a limit counts as failed."""
        worst: dict[str, float] = {}
        for claim in self.claims:
            got = {k: v for k, v in self.readings(claim, device).items() if k in self.limits}
            if not all(v <= self.limits[k] for k, v in got.items()):
                self.failed += 1
            for k, v in got.items():
                worst[k] = worse(v, worst.get(k))
        return [{"name": k, "value": v, "limit": self.limits[k]} for k, v in worst.items()]
