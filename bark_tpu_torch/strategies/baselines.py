"""Baseline strategies.

Counterpart of ``bark_tpu/strategies/baselines.py``:

  - :class:`RelaxedGPStrategy` (the reference's RelaxedSobo): a continuous
    relaxation (integers widened by 0.5, categoricals one-hot relaxed to
    boxes) under an RBF GP whose lengthscales, scale and noise Adam fits on
    the exact MLL at each ``ask``, and an LCB minimized over uniform
    candidates, rounded back through the domain;
  - :class:`GridUCBStrategy` (BARTGrid): Wilson et al.'s reparameterized LCB
    of posterior-predictive function draws over a Sobol grid, on the BARK
    surrogate by default, on BART through :func:`bart_grid_strategy`;
  - :class:`SMACStrategy` and :class:`EntmootStrategy`: wrappers of optional
    packages, which raise ``RuntimeError`` when those are absent.

Every draw can be passed in (the candidate uniforms of RelaxedGP, the
function-sample normals of GridUCB), so that a test can give the
reference's. The algebra of RelaxedGP is library Cholesky and triangular
solves, as the reference's is (no Pallas kernel of the reference runs here);
GridUCB over BARK runs the predict's kernels K1 and K2.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    IntegerInput,
)
from bark_tpu_torch.models.bart import BARTSurrogate
from bark_tpu_torch.models.surrogate import BARKSurrogate, resolve_device
from bark_tpu_torch.ops.linalg import check_matmul_precision
from bark_tpu_torch.strategies.capabilities import validate_domain

#: the baseline strategies' acquisition paths (relaxed-box LCB, ConfigSpace,
#: Sobol grid, Entmoot MIP) are all unconstrained: they neither lower nor
#: reject domain constraints, so constructing them on a constrained domain
#: fails at once (capabilities.validate_domain)
_BASELINE_FEATURES = (ContinuousInput, IntegerInput, CategoricalInput)


def _relax_bounds(domain: Domain) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Relaxed continuous box: ints +-0.5; cats -> one-hot blocks. Returns
    bounds (D_relax, 2) and the (start, size) block per original feature."""
    rows, blocks = [], []
    for f in domain.inputs:
        start = len(rows)
        if isinstance(f, CategoricalInput):
            rows.extend([(0.0, 1.0)] * len(f.categories))
            blocks.append((start, len(f.categories)))
        elif isinstance(f, IntegerInput):
            rows.append((f.bounds[0] - 0.5, f.bounds[1] + 0.5))
            blocks.append((start, 1))
        else:
            rows.append((float(f.bounds[0]), float(f.bounds[1])))
            blocks.append((start, 1))
    return np.array(rows, np.float32), blocks


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Differentiable Cholesky, NaN for a matrix that is not positive
    definite (as ``jnp.linalg.cholesky`` gives) and no host sync."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _rbf(a: torch.Tensor, b: torch.Tensor, ls: torch.Tensor, scale) -> torch.Tensor:
    d = (a[:, None, :] - b[None, :, :]) / ls
    return scale * torch.exp(-0.5 * torch.sum(d * d, dim=-1))


def _neg_mll(log_ls, log_scale, log_noise, Z, y_std):
    """The reference's objective: ||L^-1 y||^2 + 2 sum log diag L."""
    K = _rbf(Z, Z, torch.exp(log_ls), torch.exp(log_scale))
    K = K + (torch.exp(log_noise) + 1e-6) * torch.eye(Z.shape[0], device=Z.device)
    L = _cholesky(K)
    a = torch.linalg.solve_triangular(L, y_std[:, None], upper=False)[:, 0]
    return torch.sum(a * a) + 2.0 * torch.sum(torch.log(torch.diagonal(L)))


def fit_rbf_hypers(Z: torch.Tensor, y_std: torch.Tensor, ls0: torch.Tensor, steps: int):
    """Adam (lr 0.05, the reference's ``optax.adam(0.05)``) on the exact MLL
    over (log lengthscales, log scale, log noise) from (ls0, 1, 0.1).
    Returns ``(ls, scale, noise, losses)``, each loss taken before its step."""
    params = [torch.log(ls0).clone().requires_grad_(True),
              torch.zeros((), device=Z.device, requires_grad=True),
              torch.log(torch.tensor(0.1, device=Z.device)).requires_grad_(True)]
    opt = torch.optim.Adam(params, lr=0.05)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = _neg_mll(*params, Z, y_std)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    log_ls, log_scale, log_noise = (p.detach() for p in params)
    losses = torch.stack(losses) if losses else torch.zeros(0, device=Z.device)
    return torch.exp(log_ls), torch.exp(log_scale), torch.exp(log_noise), losses


def relaxed_lcb(Z, y_std, cands, ls, scale, noise, kappa):
    """The GP's LCB ``mu - kappa sd`` at relaxed candidates."""
    K = _rbf(Z, Z, ls, scale) + (noise + 1e-6) * torch.eye(Z.shape[0], device=Z.device)
    L = _cholesky(K)
    alpha = torch.cholesky_solve(y_std[:, None], L, upper=False)[:, 0]
    Kc = _rbf(cands, Z, ls, scale)
    mu = Kc @ alpha
    v = torch.linalg.solve_triangular(L, Kc.T, upper=False)
    var = torch.clamp_min(scale - torch.sum(v * v, dim=0), 1e-9)
    return mu - kappa * torch.sqrt(var)


class _History:
    """tell / add over ordinal-encoded numpy arrays."""

    def tell(self, X, y) -> None:
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])


class RelaxedGPStrategy(_History):
    """Continuous-relaxation RBF-GP LCB baseline (RelaxedSobo analogue).

    The hyperparameters are fitted by Adam on the exact MLL each ``ask``
    (``fit_hypers=False``: lengthscale 0.3 of each span, scale 1, noise
    1e-4). ``device=None`` means the CUDA device; pass ``device="cpu"`` for
    the CPU. The candidate uniforms come from a ``torch.Generator`` on the
    device, or are passed to :meth:`ask` as ``u``.
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0, kappa: float = 1.96,
                 num_candidates: int = 2048, fit_hypers: bool = True,
                 fit_steps: int = 150, device=None):
        validate_domain(type(self), domain)
        self.device = resolve_device(device)
        self.domain = domain
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.fit_hypers = fit_hypers
        self.fit_steps = fit_steps
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.bounds_relax, self.blocks = _relax_bounds(domain)
        self.X = None
        self.y = None

    def _to_relaxed(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros((X.shape[0], self.bounds_relax.shape[0]), np.float32)
        for i, (f, (start, size)) in enumerate(zip(self.domain.inputs, self.blocks)):
            if isinstance(f, CategoricalInput):
                out[np.arange(X.shape[0]), start + X[:, i].astype(int)] = 1.0
            else:
                out[:, start] = X[:, i]
        return out

    def _from_relaxed(self, Z: np.ndarray) -> np.ndarray:
        out = np.zeros((Z.shape[0], len(self.domain.inputs)), np.float32)
        for i, (f, (start, size)) in enumerate(zip(self.domain.inputs, self.blocks)):
            if isinstance(f, CategoricalInput):
                out[:, i] = np.argmax(Z[:, start : start + size], axis=1)
            else:
                out[:, i] = Z[:, start]
        return self.domain.round(out)

    def ask(self, candidate_count: int = 1, u=None) -> np.ndarray:
        """The LCB's argmin over ``num_candidates`` uniform candidates in the
        relaxed box, rounded onto the domain. ``u``: the (num_candidates,
        D_relax) uniforms (drawn when None)."""
        if self.y is None or len(self.y) < 2:
            return self.domain.sample(candidate_count, self._rng)
        check_matmul_precision()
        dev = self.device
        Z = torch.as_tensor(self._to_relaxed(self.X), device=dev)
        y = self.y
        y_std = torch.as_tensor((y - y.mean()) / max(y.std(), 1e-9), dtype=torch.float32,
                                device=dev)
        span = self.bounds_relax[:, 1] - self.bounds_relax[:, 0]
        ls = torch.as_tensor(np.maximum(span, 1e-3) * 0.3, dtype=torch.float32, device=dev)
        scale = torch.tensor(1.0, device=dev)
        noise = torch.tensor(1e-4, device=dev)
        if self.fit_hypers:
            ls, scale, noise, _ = fit_rbf_hypers(Z, y_std, ls, self.fit_steps)
        if u is None:
            u = torch.rand((self.num_candidates, self.bounds_relax.shape[0]),
                           generator=self._generator, device=dev)
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
        cands = (torch.as_tensor(self.bounds_relax[:, 0], device=dev)
                 + u * torch.as_tensor(span, device=dev))
        lcb = relaxed_lcb(Z, y_std, cands, ls, scale, noise, self.kappa)
        best = cands[torch.argmin(lcb)].cpu().numpy()[None, :]
        return self._from_relaxed(best)


class SMACStrategy(_History):
    """SMAC3 HPO-facade baseline wrapper: domain features become a
    ConfigSpace, observed experiments are replayed into the optimizer with
    ``smac.tell``, and ``ask`` pulls one suggested configuration.
    ``predict`` returns zeros. smac stays optional (a guarded import)."""

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0, n_trials: int = 100):
        validate_domain(type(self), domain)
        try:
            import ConfigSpace as cs
            from smac import HyperparameterOptimizationFacade, Scenario
        except ImportError as e:
            raise RuntimeError(
                "SMACStrategy requires the 'smac' package (not installed; "
                "the reference also treats it as optional)"
            ) from e
        self._cs = cs
        self.domain = domain
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None
        self._told = set()

        space = cs.ConfigurationSpace(seed=seed)
        for f in domain.inputs:
            if isinstance(f, CategoricalInput):
                space.add(cs.Categorical(name=f.key, items=list(f.categories)))
            elif isinstance(f, IntegerInput):
                space.add(
                    cs.Integer(name=f.key, bounds=(int(f.bounds[0]), int(f.bounds[1])))
                )
            else:
                space.add(
                    cs.Float(name=f.key, bounds=(float(f.bounds[0]), float(f.bounds[1])))
                )
        self.configspace = space
        scenario = Scenario(space, deterministic=True, n_trials=n_trials)
        self.smac = HyperparameterOptimizationFacade(
            scenario,
            lambda x, seed=0: 0.0,  # dummy objective: driven via tell/ask
            initial_design=HyperparameterOptimizationFacade.get_initial_design(
                scenario, n_configs=1
            ),
            intensifier=HyperparameterOptimizationFacade.get_intensifier(
                scenario, max_config_calls=1
            ),
            overwrite=True,
        )

    def _config_from_row(self, row: np.ndarray):
        values = {}
        for i, f in enumerate(self.domain.inputs):
            if isinstance(f, CategoricalInput):
                values[f.key] = f.categories[int(round(row[i]))]
            elif isinstance(f, IntegerInput):
                values[f.key] = int(round(row[i]))
            else:
                values[f.key] = float(row[i])
        return self._cs.Configuration(self.configspace, values=values)

    def _replay(self):
        from smac.runhistory.dataclasses import TrialInfo, TrialValue

        for row, y_val in zip(self.X, self.y):
            key = row.tobytes()
            if key in self._told:
                continue
            trial = TrialInfo(self._config_from_row(row), seed=self.seed)
            if trial not in self.smac.runhistory:
                self.smac.tell(trial, TrialValue(float(y_val)), save=False)
            self._told.add(key)

    def tell(self, X, y) -> None:
        super().tell(X, y)
        self._replay()

    def add(self, X_new, y_new) -> None:
        super().add(X_new, y_new)
        self._replay()

    def has_sufficient_experiments(self) -> bool:
        return self.y is not None and len(self.y) >= 1

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        if candidate_count != 1:
            raise ValueError("SMAC only supports single candidates")
        info = self.smac.ask()
        cfg = dict(info.config)
        row = np.zeros((len(self.domain.inputs),), np.float32)
        for i, f in enumerate(self.domain.inputs):
            v = cfg[f.key]
            if isinstance(f, CategoricalInput):
                row[i] = f.categories.index(v)
            else:
                row[i] = float(v)
        return row[None, :]

    def predict(self, X) -> tuple[np.ndarray, np.ndarray]:
        """Dummy predictions (zeros), as the reference's."""
        n = len(next(iter(X.values()))) if isinstance(X, dict) else len(X)
        return np.zeros((n, 1)), np.zeros((n, 1))


def smac_strategy(domain: Domain, **kwargs):
    """The SMAC entry point (raises without smac, as the reference's)."""
    return SMACStrategy(domain, **kwargs)


class GridUCBStrategy(_History):
    """Sobol-grid reparameterized-UCB strategy (BARTGrid analogue).

    A grid of ``min(2^(5D), max_grid)`` scrambled Sobol points (seeded by the
    ask count), posterior-predictive function draws on it, and Wilson et
    al. 2018 (Eq 7)'s reparameterized LCB for minimization,
    ``mean_s(-mu + kappa sqrt(pi/2) |y_s - mu|)``, maximized over the grid.
    Any surrogate with ``function_samples`` works; the default is the BARK
    surrogate (``device=None``: the CUDA device), BART's comes through
    :func:`bart_grid_strategy`. The draws' normals come from a numpy
    generator seeded by the ask count, or are passed to :meth:`ask`.
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, surrogate=None, seed: int = 0,
                 kappa: float = 1.96, max_grid: int = 2**14, params=None, device=None):
        validate_domain(type(self), domain)
        self.domain = domain
        self.surrogate = surrogate or BARKSurrogate(domain, params, seed=seed, device=device)
        self.device = self.surrogate.device
        self.kappa = kappa
        self.max_grid = max_grid
        self.seed = seed
        self._ask_count = 0
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

    def tell(self, X, y) -> None:
        super().tell(X, y)
        self.surrogate.fit(self.X, self.y)

    def add(self, X_new, y_new) -> None:
        super().add(X_new, y_new)
        self.surrogate.fit(self.X, self.y)

    def has_sufficient_experiments(self) -> bool:
        return self.y is not None and len(self.y) > 1

    def next_grid(self) -> np.ndarray:
        """The grid of the next ask (advances the ask count)."""
        n = min(2 ** (5 * self.domain.dim), self.max_grid)
        grid = self.domain.sample_sobol(n, seed=self.seed + self._ask_count)
        self._ask_count += 1
        return grid

    def ask(self, candidate_count: int = 1, eps=None) -> np.ndarray:
        """The grid point of largest reparameterized LCB, ``(1, D)``. ``eps``:
        the (1, S, grid) standard normals of the function draws."""
        if candidate_count != 1:
            raise ValueError("grid UCB proposes single candidates")
        if not self.has_sufficient_experiments() or not self.surrogate.is_fitted:
            return self.domain.sample(1, self._rng)
        grid = self.next_grid()
        if eps is None:
            eps = np.random.default_rng(self.seed + self._ask_count)
        draws = self.surrogate.function_samples(grid, eps=eps)  # (S, n)
        return grid[int(np.argmax(reparam_lcb(draws, self.kappa)))][None, :]

    def predict(self, X):
        return self.surrogate.predict(X)


def reparam_lcb(draws: np.ndarray, kappa: float) -> np.ndarray:
    """Wilson et al.'s reparameterized LCB of function draws (S, n) -> (n,)."""
    mu = draws.mean(axis=0, keepdims=True)
    return (-mu + kappa * np.sqrt(np.pi / 2) * np.abs(draws - mu)).mean(axis=0)


def bart_grid_strategy(domain: Domain, seed: int = 0, device=None, **kwargs):
    """BARTGrid: grid-UCB over the native BART posterior."""
    sur = BARTSurrogate(domain, kwargs.pop("bart_params", None), seed=seed, device=device)
    return GridUCBStrategy(domain, surrogate=sur, seed=seed, **kwargs)


class EntmootStrategy(_History):
    """Entmoot (tree ensemble + MIP acquisition) baseline wrapper, with the
    reference's solver options TimeLimit=60, MIPGap=0.05. Entmoot needs a
    Gurobi licence: a guarded import raises when the package is absent."""

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0,
                 time_limit: int = 60, mip_gap: float = 0.05):
        validate_domain(type(self), domain)
        try:
            from entmoot import Enting, GurobiOptimizer, ProblemConfig
        except ImportError as e:
            raise RuntimeError(
                "EntmootStrategy requires the 'entmoot' package (and a "
                "Gurobi license), neither installed here; the reference "
                "treats it as an optional study baseline too "
                "(bark_study_strategy.py:84-89)"
            ) from e
        self.domain = domain
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

        pc = ProblemConfig(rnd_seed=seed)
        for f in domain.inputs:
            if isinstance(f, CategoricalInput):
                pc.add_feature("categorical", tuple(f.categories), name=f.key)
            elif isinstance(f, IntegerInput):
                pc.add_feature("integer", (int(f.bounds[0]), int(f.bounds[1])), name=f.key)
            else:
                pc.add_feature("real", (float(f.bounds[0]), float(f.bounds[1])), name=f.key)
        pc.add_min_objective(name="y")
        self._pc = pc
        self._enting = Enting(pc, params={"unc_params": {"dist_metric": "l1"}})
        self._solver_params = {"TimeLimit": time_limit, "MIPGap": mip_gap,
                               "LogToConsole": 0}
        self._opt_cls = GurobiOptimizer

    def tell(self, X, y) -> None:
        self.X = np.asarray(X, np.float64)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new) -> None:
        X_new = np.atleast_2d(np.asarray(X_new, np.float64))
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, y_new)
        else:
            self.tell(np.vstack([self.X, X_new]), np.concatenate([self.y, y_new]))

    def ask(self, n: int = 1) -> np.ndarray:
        if self.X is None or len(self.y) < 2:
            return self.domain.sample(n, self._rng)
        self._enting.fit(self.X, self.y.reshape(-1, 1))
        opt = self._opt_cls(self._pc, params=self._solver_params)
        res = opt.solve(self._enting)
        x = np.asarray(res.opt_point, np.float64).reshape(1, -1)
        return np.vstack([x] + [self.domain.sample(1, self._rng) for _ in range(n - 1)])
