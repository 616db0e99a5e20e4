"""Massively parallel acquisition search.

Counterpart of ``bark_tpu/optimizer/search.py``. The acquisition depends on
x only through the leaves x lands in, so it is constant within the
intersection box of those leaves. The search uses that structure:

  1. score a large uniform candidate batch (one batched acquisition call);
  2. evolutionary refinement rounds: mutate the top-k candidates with
     per-feature-type moves (Gaussian for continuous, jitter for integer,
     resample for categorical) at a decaying scale;
  3. compute the active leaf box of the winner across every sampled tree
     (exact subspace intersection) and return the box center (categorical:
     a random allowed category; integer: stochastic rounding; continuous:
     the midpoint).

Because the acquisition is constant on the box, step 3 never degrades the
score; it moves the proposal away from arbitrary box edges.

Constraints are honored in two places:

  - the global search adds a feasibility penalty to every scored batch, so
    elites descend toward the feasible region even when a uniform batch
    contains no feasible point;
  - the leaf-centering step returns the feasible point nearest the box
    center under the distance metric "squared for numerics, +1 per
    differing category", found by sampled projection, segment bisection and
    an L-BFGS penalty polish, with an epsilon-widening retry loop (epsilon
    escalates x10, so the loop terminates).

Constraint expressions are arbitrary Python callables, so that half runs on
the host in numpy, once per BO iteration, as in the reference; it consumes
the numpy ``rng`` call for call, so the same generator gives the same
centre in both packages.

Randomness of the device half comes in as tensors: one :class:`SearchDraws`
per :func:`propose` (made by :func:`draw_search` from a ``torch.Generator``),
so the same draws give the same candidates in both packages. The scored
batches are full of exact ties (the acquisition is piecewise constant), so
the elites are selected with a stable sort: among equal scores the lowest
index comes first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bark_tpu_torch.constraints import is_feasible, total_violation
from bark_tpu_torch.domain import CategoricalInput, Domain, IntegerInput
from bark_tpu_torch.fitting.traversal import node_subspace
from bark_tpu_torch.forest import FEAT_CAT, FEAT_INT, route_forest
from bark_tpu_torch.optimizer.acquisition import DEFAULT_KAPPA, evaluate_acquisition


class AcquisitionFailure(RuntimeError):
    """Every score of a candidate batch was non-finite: the acquisition state
    cannot rank candidates (a posterior whose kernels failed to factor at
    every jitter escalation)."""


class UniformDraws(NamedTuple):
    """Uniforms on [0, 1) of the first candidate batch, each (n, D)."""

    u_cont: torch.Tensor
    u_disc: torch.Tensor


class MutateDraws(NamedTuple):
    """Randomness of one mutation round for n children of D features."""

    idx: torch.Tensor  # (n,) int64 parent of each child, in [0, top_k)
    u_mask: torch.Tensor  # (n, D) uniform: a feature mutates where < 0.3
    z_cont: torch.Tensor  # (n, D) standard normal, continuous step
    z_int: torch.Tensor  # (n, D) standard normal, integer step
    u_cat: torch.Tensor  # (n, D) uniform, categorical resample


class SearchDraws(NamedTuple):
    """All device randomness of one :func:`propose`."""

    uniform: UniformDraws
    rounds: tuple[MutateDraws, ...]

    def to(self, device) -> "SearchDraws":
        return SearchDraws(
            UniformDraws(*(t.to(device) for t in self.uniform)),
            tuple(MutateDraws(*(t.to(device) for t in r)) for r in self.rounds),
        )


def draw_search(
    generator: torch.Generator,
    num_candidates: int,
    dim: int,
    num_rounds: int,
    top_k: int = 64,
    device=None,
) -> SearchDraws:
    """Draw one search's randomness on the generator's device, moved to
    ``device`` (the distributions of the reference's keyed draws)."""
    dev = generator.device
    shape = (num_candidates, dim)
    rand = lambda: torch.rand(shape, generator=generator, device=dev)  # noqa: E731
    randn = lambda: torch.randn(shape, generator=generator, device=dev)  # noqa: E731
    uniform = UniformDraws(rand(), rand())
    rounds = tuple(
        MutateDraws(
            torch.randint(top_k, (num_candidates,), generator=generator, device=dev),
            rand(), randn(), randn(), rand(),
        )
        for _ in range(num_rounds)
    )
    draws = SearchDraws(uniform, rounds)
    return draws if device is None else draws.to(device)


def _uniform_candidates(
    draws: UniformDraws, bounds_ord: torch.Tensor, feat_types: torch.Tensor
) -> torch.Tensor:
    """Uniform batch in ordinal data space (cats/ints uniform over values).

    ``u * span + lb`` is rounded once, as a fused multiply-add (the
    reference's compiled lowering contracts it): float64 holds the product
    of two float32 exactly, so the sum rounds to float32 once.
    """
    lb, ub = bounds_ord[:, 0], bounds_ord[:, 1]
    span = ub - lb

    def fma(u, a):
        return (u.double() * a.double() + lb.double()).float()

    cont = fma(draws.u_cont, span)
    disc = torch.clamp(torch.floor(fma(draws.u_disc, span + 1.0)), lb, ub)
    is_disc = (feat_types == FEAT_CAT) | (feat_types == FEAT_INT)
    return torch.where(is_disc[None, :], disc, cont).to(torch.float32)


def _mutate(
    draws: MutateDraws,
    parents: torch.Tensor,
    bounds_ord: torch.Tensor,
    feat_types: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Per-feature-type mutations of top candidates (each float32 operation
    rounded on its own, as the reference runs this function eagerly)."""
    lb, ub = bounds_ord[:, 0], bounds_ord[:, 1]
    span = ub - lb
    base = parents[draws.idx]
    mutate_mask = draws.u_mask < 0.3
    sigma = torch.tensor(sigma, dtype=torch.float32, device=parents.device)
    cont_step = base + sigma * span * draws.z_cont
    int_step = base + torch.round(sigma * torch.clamp_min(span, 1.0) * draws.z_int)
    cat_step = torch.floor(draws.u_cat * (span + 1.0) + lb)
    ft = feat_types[None, :]
    stepped = torch.where(
        ft == FEAT_CAT, cat_step, torch.where(ft == FEAT_INT, int_step, cont_step)
    )
    stepped = torch.clamp(stepped, lb, ub)
    return torch.where(mutate_mask, stepped, base).to(torch.float32)


def _leaf_box(
    acq,
    x: torch.Tensor,
    bounds_bitmask: torch.Tensor,
    feat_types: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Intersection of the subspaces of every leaf x lands in: ``(D, 2)``.

    Exact: the ``node_subspace`` walk the sampler uses, over all
    (samples x trees) leaves at once; numeric bounds intersect by max/min,
    categorical masks by bitwise AND.
    """
    leaves = route_forest(acq.forest, x[None, :], feat_types, max_depth)[..., 0, :]  # (S, m)
    boxes = node_subspace(acq.forest, leaves, bounds_bitmask, feat_types, max_depth)
    boxes = boxes.reshape(-1, *boxes.shape[-2:])  # (S * m, D, 2)
    lo = boxes[:, :, 0].amax(0)
    hi = boxes[:, :, 1].amin(0)
    # AND over the batch, bit by bit (bitmasks use at most MAX_CATEGORIES bits)
    bits = torch.arange(31, device=x.device)
    masks = boxes[:, :, 1].to(torch.int32)
    common = ((masks[..., None] >> bits) & 1).all(0)  # (D, 31)
    cat_mask = (common.to(torch.int32) << bits).sum(-1).to(torch.float32)
    is_cat = feat_types == FEAT_CAT
    lo = torch.where(is_cat, 0.0, lo)
    hi = torch.where(is_cat, cat_mask, hi)
    return torch.stack([lo, hi], dim=1)


def _box_center(
    box: np.ndarray, domain: Domain, rng: np.random.Generator
) -> np.ndarray:
    """Center point of an active-leaf box in ordinal data space:
    categorical: uniform choice among allowed categories; integer: midpoint
    with stochastic rounding; continuous: midpoint."""
    out = np.zeros((len(domain.inputs),), np.float32)
    for i, feat in enumerate(domain.inputs):
        lb, ub = float(box[i, 0]), float(box[i, 1])
        if isinstance(feat, CategoricalInput):
            mask = int(ub)
            allowed = [c for c in range(len(feat.categories)) if mask & (1 << c)]
            if not allowed:
                allowed = list(range(len(feat.categories)))
            out[i] = rng.choice(allowed)
        elif isinstance(feat, IntegerInput):
            mid = lb + (ub - lb) / 2
            floor = np.floor(mid)
            out[i] = floor + rng.binomial(1, mid - floor)
        else:
            out[i] = lb + (ub - lb) / 2
    return out


# --- constraint handling (host-side numpy; see the module docstring) -------


def _penalize(
    scores: torch.Tensor, cands: torch.Tensor, constraints, keys: list[str]
) -> torch.Tensor:
    """Add a feasibility penalty so selection is feasible-first.

    Infeasible candidates pay the current batch's score span once (a fixed
    step: never preferred over a feasible point of any score in the batch)
    plus a slope proportional to the violation (a descent direction toward
    the feasible region).
    """
    if not constraints:
        return scores
    viol = total_violation(constraints, cands.cpu().numpy().astype(np.float64), keys)
    s = scores.cpu().numpy().astype(np.float64)
    span = float(np.max(s) - np.min(s)) + 1.0
    out = (s + span * (viol + (viol > 1e-6))).astype(np.float32)
    return torch.as_tensor(out, device=scores.device)


def _sample_in_box(
    box: np.ndarray, domain: Domain, rng: np.random.Generator, n: int
) -> np.ndarray:
    """Uniform samples inside an active-leaf box (cats within the mask)."""
    out = np.zeros((n, len(domain.inputs)), np.float32)
    for i, feat in enumerate(domain.inputs):
        lb, ub = float(box[i, 0]), float(box[i, 1])
        if isinstance(feat, CategoricalInput):
            mask = int(ub)
            allowed = [c for c in range(len(feat.categories)) if mask & (1 << c)]
            if not allowed:
                allowed = list(range(len(feat.categories)))
            out[:, i] = rng.choice(allowed, size=n)
        elif isinstance(feat, IntegerInput):
            out[:, i] = rng.integers(int(np.ceil(lb)), int(np.floor(ub)) + 1, size=n)
        else:
            out[:, i] = rng.uniform(lb, ub, size=n)
    return out


def _center_dist(X: np.ndarray, center: np.ndarray, is_cat: np.ndarray):
    """Squared distance over numerics, +1 per differing category."""
    num = np.where(is_cat[None, :], 0.0, X - center[None, :])
    cat = is_cat[None, :] & (X != center[None, :])
    return (num**2).sum(axis=1) + cat.sum(axis=1)


def _bisect_toward(
    x: np.ndarray,
    center: np.ndarray,
    domain: Domain,
    constraints,
    is_cat: np.ndarray,
    iters: int = 24,
) -> np.ndarray:
    """Largest feasible step from a feasible x toward the center along the
    numeric segment (categories stay put)."""
    keys = domain.input_keys
    lo, hi = 0.0, 1.0

    def at(t):
        trial = x.copy()
        trial[~is_cat] = x[~is_cat] + t * (center[~is_cat] - x[~is_cat])
        return domain.round(trial[None])[0]

    if is_feasible(constraints, at(1.0)[None], keys)[0]:
        return at(1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if is_feasible(constraints, at(mid)[None], keys)[0]:
            lo = mid
        else:
            hi = mid
    return at(lo)


def _penalty_polish(
    x0: np.ndarray,
    center: np.ndarray,
    box: np.ndarray,
    domain: Domain,
    constraints,
    is_cat: np.ndarray,
) -> np.ndarray | None:
    """L-BFGS-B penalty descent on the numeric dims (helps equality
    constraints, which segment bisection cannot hold). Returns a feasible
    point or None."""
    from scipy.optimize import minimize

    keys = domain.input_keys
    free = np.flatnonzero(~is_cat)
    if free.size == 0:
        return None
    bnds = [(float(box[i, 0]), float(box[i, 1])) for i in free]

    x64 = x0.astype(np.float64)  # float32 would swallow the FD steps
    c64 = center.astype(np.float64)
    for w in (1e3, 1e6, 1e9):

        def objective(z):
            x = x64.copy()
            x[free] = z
            v = total_violation(constraints, x[None], keys)[0]
            d = float(((z - c64[free]) ** 2).sum())
            return d + w * v**2

        res = minimize(objective, x64[free], method="L-BFGS-B", bounds=bnds)
        x = x64.copy()
        x[free] = res.x
        x = domain.round(x[None])[0]
        if is_feasible(constraints, x[None], keys)[0]:
            return x
        x64 = x.astype(np.float64)
    return None


def _widen_box(
    box: np.ndarray, domain: Domain, eps: float, is_cat: np.ndarray
) -> np.ndarray:
    """Relax numeric box bounds by eps, clipped to the domain."""
    bounds = domain.bounds("ordinal")
    out = box.copy()
    out[~is_cat, 0] = np.maximum(box[~is_cat, 0] - eps, bounds[~is_cat, 0])
    out[~is_cat, 1] = np.minimum(box[~is_cat, 1] + eps, bounds[~is_cat, 1])
    return out


def _is_cat(domain: Domain) -> np.ndarray:
    return np.array([isinstance(f, CategoricalInput) for f in domain.inputs], bool)


def _constrained_center(
    box: np.ndarray,
    domain: Domain,
    constraints,
    rng: np.random.Generator,
    n_local: int = 512,
    max_widen: int = 12,
) -> np.ndarray:
    """Feasible point nearest the active-box center, with widening retries.

    Sampled projection: draw candidates in the box, bisect each feasible one
    toward the center, keep the closest; polish with a penalty descent.
    Epsilon starts at 1e-5 and escalates x10 per retry, so the loop
    terminates; if the box grows to the whole domain with nothing feasible,
    the minimum-violation point is returned.
    """
    keys = domain.input_keys
    is_cat = _is_cat(domain)
    eps = 1e-5
    best_fallback, best_fallback_viol = None, np.inf

    for _ in range(max_widen):
        center = _box_center(box, domain, rng)
        if is_feasible(constraints, center[None], keys)[0]:
            return center

        cand = np.vstack([center[None], _sample_in_box(box, domain, rng, n_local)])
        viol = total_violation(constraints, cand, keys)
        feas = viol <= 1e-6

        i_min = int(np.argmin(viol))
        if viol[i_min] < best_fallback_viol:
            best_fallback, best_fallback_viol = cand[i_min], viol[i_min]

        if feas.any():
            feas_pts = cand[feas]
            dists = _center_dist(feas_pts, center, is_cat)
            # bisect the few closest feasible points toward the center
            order = np.argsort(dists)[:8]
            refined = np.stack(
                [
                    _bisect_toward(feas_pts[j], center, domain, constraints, is_cat)
                    for j in order
                ]
            )
            refined_d = _center_dist(refined, center, is_cat)
            best = refined[int(np.argmin(refined_d))]
            polished = _penalty_polish(
                best, center, box, domain, constraints, is_cat
            )
            if polished is not None and _center_dist(
                polished[None], center, is_cat
            )[0] < _center_dist(best[None], center, is_cat)[0]:
                best = polished
            return best

        # nothing feasible in the box: try a penalty descent from the least
        # violating point before widening
        polished = _penalty_polish(
            cand[i_min], center, box, domain, constraints, is_cat
        )
        if polished is not None:
            return polished

        box = _widen_box(box, domain, eps, is_cat)
        eps *= 10.0

    # all retries exhausted: project the least-violating point found onto
    # the feasible region before conceding (a feasible point further from
    # the center is preferred over an infeasible one near it)
    if best_fallback is not None:
        x = _violation_descent(best_fallback, domain, constraints, is_cat)
        if is_feasible(constraints, x[None], keys)[0]:
            return x
        return best_fallback
    return _box_center(box, domain, rng)


def _margin_violation(
    constraints, X: np.ndarray, keys: list[str], margin_rel: float
) -> np.ndarray:
    """total_violation with inequality rows tightened per constraint: descent
    targets (slightly) the strict interior, so float32 rounding of the
    result cannot push it back over the boundary. The margin scales with
    each constraint's magnitude (``margin_rel * (|rhs| + 1)``): float32
    rounding of x perturbs a constraint of magnitude ~1e6 by ~0.1, so any
    absolute margin is either too loose or too tight somewhere."""
    out = np.zeros(X.shape[0], np.float64)
    for c in constraints:
        try:
            g = np.asarray(c.expr(X, keys), np.float64) - c.rhs
            m = margin_rel * (abs(float(c.rhs)) + 1.0)
            out += np.abs(g) if c.is_equality else np.maximum(g + m, 0.0)
        except NotImplementedError:  # NChooseK has no smooth expr
            out += c.violation(X, keys)
    return out


def _violation_descent(
    x0: np.ndarray, domain: Domain, constraints, is_cat: np.ndarray
) -> np.ndarray:
    """L-BFGS-B descent on the squared total violation over numeric dims.

    Turns a near-feasible draw into a feasible one when rejection sampling
    is hopeless (a feasible region of ~1e-5 of its box)."""
    from scipy.optimize import minimize

    keys = domain.input_keys
    free = np.flatnonzero(~is_cat)
    if free.size == 0:
        return x0
    bounds = domain.bounds("ordinal")
    bnds = [(float(bounds[i, 0]), float(bounds[i, 1])) for i in free]

    x64 = x0.astype(np.float64)  # float32 would swallow the FD steps

    def objective(z):
        x = x64.copy()
        x[free] = z
        return float(_margin_violation(constraints, x[None], keys, 1e-6)[0] ** 2)

    res = minimize(objective, x64[free], method="L-BFGS-B", bounds=bnds)
    x = x64.copy()
    x[free] = res.x
    return domain.round(x[None])[0]


def sample_feasible(
    domain: Domain,
    n: int,
    rng: np.random.Generator,
    constraints=None,
    max_tries: int = 16,
) -> np.ndarray:
    """Rejection-sample feasible domain points, polishing near-misses with a
    violation descent when the feasible region is too small to hit."""
    constraints = domain.constraints if constraints is None else constraints
    if not constraints:
        return domain.sample(n, rng)
    keys = domain.input_keys
    is_cat = _is_cat(domain)
    out: list[np.ndarray] = []
    near_misses: list[tuple[float, np.ndarray]] = []
    for _ in range(max_tries):
        X = domain.sample(max(n * 8, 64), rng)
        viol = total_violation(constraints, X, keys)
        feas = np.flatnonzero(viol <= 1e-6)
        out.extend(X[feas][: n - len(out)])
        for i in np.argsort(viol)[:4]:
            near_misses.append((float(viol[i]), X[i]))
        if len(out) >= n:
            return np.stack(out[:n])
    # polish the least-violating draws into feasibility
    near_misses.sort(key=lambda t: t[0])
    for _, x0 in near_misses:
        x = _violation_descent(x0, domain, constraints, is_cat)
        if is_feasible(constraints, x[None], keys)[0]:
            out.append(x)
        if len(out) >= n:
            return np.stack(out[:n])
    # give up gracefully: pad with the minimum-violation points found
    pad = [x for _, x in near_misses[: n - len(out)]]
    return np.stack(list(out) + pad)


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k lowest scores, ties by lowest index first."""
    return torch.sort(scores, stable=True).indices[:k]


def propose(
    draws: SearchDraws,
    acq,
    domain: Domain,
    feat_types: torch.Tensor,
    kappa: float = DEFAULT_KAPPA,
    top_k: int = 64,
    max_depth: int = 16,
    return_center: bool = True,
    rng: np.random.Generator | None = None,
    constraints=None,
    seeds: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """Optimize the acquisition; returns (proposal ordinal point, acq value).

    The number of candidates and of refinement rounds are those of
    ``draws`` (:func:`draw_search`). Domain constraints are enforced by
    penalty during the search and exactly at the centering step. ``seeds``
    (K, D) replace the first K candidates of round 0 (the incumbent, the
    previous proposal). Raises :class:`AcquisitionFailure` when every score
    of a batch is non-finite.
    """
    rng = rng or np.random.default_rng()
    constraints = domain.constraints if constraints is None else constraints
    keys = domain.input_keys
    device = feat_types.device
    bounds_ord = torch.as_tensor(domain.bounds("ordinal"), device=device)
    bounds_bitmask = torch.as_tensor(domain.bounds("bitmask"), device=device)

    cands = _uniform_candidates(draws.uniform, bounds_ord, feat_types)
    if seeds is not None and len(seeds):
        k = min(len(seeds), cands.shape[0])
        cands[:k] = torch.as_tensor(np.asarray(seeds[:k], np.float32), device=device)

    def score(batch):
        scores = evaluate_acquisition(acq, batch, feat_types, max_depth, kappa)
        finite = torch.isfinite(scores)
        if not bool(finite.any()):
            raise AcquisitionFailure(
                f"all {scores.numel()} acquisition scores of a batch are non-finite"
            )
        scores = torch.where(finite, scores, torch.inf)
        return _penalize(scores, batch, constraints, keys)

    scores = score(cands)
    best_idx = _top(scores, top_k)
    elites, elite_scores = cands[best_idx], scores[best_idx]

    sigma = 0.2
    for round_draws in draws.rounds:
        children = _mutate(round_draws, elites, bounds_ord, feat_types, sigma)
        child_scores = score(children)
        pool = torch.cat([elites, children])
        pool_scores = torch.cat([elite_scores, child_scores])
        best_idx = _top(pool_scores, top_k)
        elites, elite_scores = pool[best_idx], pool_scores[best_idx]
        sigma *= 0.5

    x_best = elites[0]
    best_val = float(elite_scores[0])
    if not return_center:
        return x_best.cpu().numpy(), best_val

    box = _leaf_box(acq, x_best, bounds_bitmask, feat_types, max_depth).cpu().numpy()
    if not constraints:
        return _box_center(box, domain, rng), best_val
    center = _constrained_center(box, domain, constraints, rng)

    # Final feasibility gate, judged on the float32 round trip of the point:
    # the centering works in float64 and favours the constraint boundary
    # (the constrained optimum usually sits there), but a boundary-exact
    # point flips infeasible under later float32 casts (a constraint of
    # magnitude ~1e6 moves ~0.1 per float32 ulp of x). Repair with the
    # margin-targeting violation descent, then feasible sampling: a
    # constrained ask never proposes a float32-infeasible candidate while
    # any feasible point is findable.
    def f32_ok(x):
        x32 = np.asarray(x, np.float32).astype(np.float64)
        return bool(is_feasible(constraints, x32[None], keys)[0])

    if not f32_ok(center):
        x = _violation_descent(
            np.asarray(center, np.float64), domain, constraints, _is_cat(domain)
        )
        center = x if f32_ok(x) else sample_feasible(domain, 1, rng, constraints)[0]
    return np.asarray(center, np.float64), best_val
