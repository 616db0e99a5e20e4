"""One sampler step of a unit, kept whole for the check of its move scan.

:class:`StepRecorder` wraps the sampler's step (``fitting/sampler.step_with_info``)
and its proposal batch (``fitting/sampler._propose_all_trees``) in their
module while it is installed. Armed with a step index, it counts the steps
of the next sampler call and keeps, for that one step, copies of what the
move scan was given and what it decided: the input forests with their noise
and scale, the m proposed trees (packed as the program packs them), each
move's proposal log ratio and uniform draw, the scan's accepts and log
alphas, and the forests the step returned. The copies are device-side and
need no synchronisation; every other step passes through untouched.
"""

from __future__ import annotations

import torch


def _forest(forest) -> dict:
    return {k: v.clone() for k, v in zip(forest._fields, forest)}


class StepRecorder:
    def __init__(self):
        self.kept: list[dict] = []
        self._armed: int | None = None
        self._count = 0
        self._batch = None
        self._want = False
        self._saved = None
        self._stop = None

    def install(self) -> "StepRecorder":
        from bark_tpu_torch.fitting import sampler

        step, propose = sampler.step_with_info, sampler._propose_all_trees

        def recorded_propose(*args, **kwargs):
            packed0, batch = propose(*args, **kwargs)
            if self._want:
                self._batch = batch
            return packed0, batch

        def recorded_step(state, *args, **kwargs):
            take = self._armed is not None and self._count == self._armed
            self._count += 1
            self._want, self._batch = take, None
            try:
                new, info = step(state, *args, **kwargs)
            finally:
                self._want = False
            if self._stop is not None:
                self._stop[0] -= 1
                if self._stop[0] == 0:
                    hook, self._stop = self._stop[1], None
                    hook()
            if take:
                self._armed = None
                batch = self._batch
                self.kept.append({
                    "forest": _forest(state.forest), "noise": state.noise.clone(),
                    "scale": state.scale.clone(),
                    "proposed": None if batch is None else batch.new_packed.clone(),
                    "log_q": None if batch is None else batch.log_q_prior.clone(),
                    "u": None if batch is None else batch.u_accept.clone(),
                    "accepts": info.tree_accepts.clone(),
                    "log_alpha": info.tree_log_alpha.clone(),
                    "after": _forest(new.forest),
                })
                self._batch = None
            return new, info

        self._saved = (sampler, step, propose)
        sampler.step_with_info, sampler._propose_all_trees = recorded_step, recorded_propose
        return self

    def uninstall(self) -> None:
        if self._saved is not None:
            sampler, step, propose = self._saved
            sampler.step_with_info, sampler._propose_all_trees = step, propose
            self._saved = None

    def arm(self, step_index: int) -> None:
        """Keep step ``step_index`` (from 0) of the steps that follow."""
        self._armed, self._count = step_index, 0

    def after_steps(self, count: int, hook) -> None:
        """Call ``hook()`` once, after the ``count``-th step from now."""
        self._stop = [count, hook]

    def take(self) -> dict | None:
        """The step kept since the last take, or None (not reached)."""
        out = self.kept.pop() if self.kept else None
        self.kept.clear()
        self._armed = None
        return out


def on_host(step: dict | None) -> dict | None:
    """A kept step with the proposals unpacked (by the program's own
    ``unpack_forest``, which reads its packing) and every tensor on the host."""
    if step is None or step["proposed"] is None:
        return None
    from bark_tpu_torch.forest import unpack_forest

    proposed = unpack_forest(step["proposed"])
    out = {k: (v if not isinstance(v, torch.Tensor) else v.cpu())
           for k, v in step.items() if k != "proposed"}
    out["forest"] = {k: v.cpu() for k, v in step["forest"].items()}
    out["after"] = {k: v.cpu() for k, v in step["after"].items()}
    out["proposed"] = {k: v.cpu() for k, v in zip(proposed._fields, proposed)}
    return out


def readings(step: dict, X, y, feat_types, m: int, jitter: float, gap_limit: float,
             precision: str = "program", block: int = 8) -> dict:
    """The numbers compared for one kept step (on the host, :func:`on_host`),
    against the float64 replay of its moves (``reference/moves.py``). A
    move is accepted where u <= p = min(1, exp(log alpha)), log alpha the
    proposal's log ratio (the program's, as the step drew it) plus the
    move's MLL difference:

    - ``accept_gap``: the worst gap between a move's acceptance
      probability p as the scan had it and as the replay has it (a vetoed
      move has p = 0). Moves that are certain either way read no gap
      however far apart their log alphas lie;
    - ``scan_flips``: decisions that differ from the replay's, u <= p,
      where u lies farther from the replay's p than ``gap_limit``;
    - ``merge_mismatch``: trees of the returned forests whose leaves are
      neither the proposal's (accepted) nor the input's (rejected).

    ``precision`` "program" judges the program; "tf32" the control, the
    replay computed in TF32 in the scan's place (its decisions its own)."""
    from perfbench.reference.forest import route
    from perfbench.reference.moves import move_deltas

    device = X.device
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    forest, proposed = to(step["forest"]), to(step["proposed"])
    accepts = step["accepts"].to(device)
    noise, scale = step["noise"].to(device), step["scale"].to(device)
    log_q = step["log_q"].to(device, torch.float64)
    u = step["u"].to(device, torch.float64)
    prob = lambda log_alpha: torch.exp(torch.clamp_max(log_alpha, 0.0))  # noqa: E731
    args = (forest, proposed, accepts, noise, scale, X, y, feat_types, m, jitter)
    p_ref = prob(log_q + move_deltas(*args, block=block))
    if precision == "program":
        p_got = prob(step["log_alpha"].to(device, torch.float64))
        acc = accepts
    else:
        p_got = prob(log_q + move_deltas(*args, precision=precision, block=block))
        acc = u <= p_got
    clear = (u - p_ref).abs() > gap_limit
    out = {"accept_gap": float((p_got - p_ref).abs().max()),
           "scan_flips": int(((acc != (u <= p_ref)) & clear).sum()),
           "merge_mismatch": 0}
    if precision == "program":
        after_all, bad = to(step["after"]), 0
        for lo in range(0, noise.shape[0], block):
            rows = slice(lo, min(lo + block, noise.shape[0]))
            part = lambda d: {k: v[rows] for k, v in d.items()}  # noqa: E731
            cur, prop, after = (route(part(f), X.to(torch.float32), feat_types)
                                for f in (forest, proposed, after_all))
            want = torch.where(accepts[rows][:, None, :], prop, cur)
            bad += int((after != want).any(1).sum())
        out["merge_mismatch"] = bad
    return out
