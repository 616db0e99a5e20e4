"""Multi-task (multi-fidelity) tree-kernel GP: LeafMOGP.

Counterpart of ``bark_tpu/models/mogp.py``. The kernel between
observations (x, i) and (x', j) is ``agreement(x, x') * B[i, j]`` with the
rank-1-plus-diagonal index kernel ``B = w w^T + diag(v)`` over the tasks
(fidelities), and the noise is per task. The forest comes from the booster
(:func:`~bark_tpu_torch.fitting.booster.fit_booster_forest`) and stays
fixed; the task and noise hyperparameters maximize the exact MLL by Adam
(300 steps at learning rate 0.05, the reference's ``optax.adam(0.05)``),
differentiating through ``torch.linalg.cholesky_ex`` (a library call, as
the reference's ``jnp.linalg.cholesky`` is).

Every agreement Gram is a launch of kernel K1 (``ops.gram``) on the one
forest: the training Gram once per fit (symmetric), and in
:meth:`LeafMOGPSurrogate._posterior_joint` the cross and the new-point
Grams. The joint posterior solves with ``torch.linalg.solve``, as the
reference does with ``jnp.linalg.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bark_tpu_torch.domain import Domain, Standardize
from bark_tpu_torch.fitting.booster import fit_booster_forest
from bark_tpu_torch.forest import Forest, gram_from_leaves, route_forest
from bark_tpu_torch.models.leafgp import _cholesky, _softplus
from bark_tpu_torch.models.surrogate import resolve_device
from bark_tpu_torch.ops.linalg import JITTER, check_matmul_precision


class MOGPParams(NamedTuple):
    task_w: torch.Tensor  # (T,) rank-1 factor of the index kernel
    raw_task_v: torch.Tensor  # (T,) softplus parameter of its diagonal
    raw_noise: torch.Tensor  # (T,) softplus parameter of the per-task noise


def task_covariance(params: MOGPParams) -> torch.Tensor:
    """``B = w w^T + diag(softplus(raw_v))``, (T, T)."""
    w = params.task_w
    return torch.outer(w, w) + torch.diag(_softplus(params.raw_task_v))


def mogp_kernel(
    gram: torch.Tensor, tasks1: torch.Tensor, tasks2: torch.Tensor, params: MOGPParams
) -> torch.Tensor:
    """The product kernel: the agreement Gram times the task covariance
    looked up at each pair's tasks."""
    B = task_covariance(params)
    return gram * B[tasks1[:, None], tasks2[None, :]]


def _mogp_mll(params: MOGPParams, gram, tasks, y) -> torch.Tensor:
    """The MLL (up to the constant) of y under the multi-task kernel."""
    K = mogp_kernel(gram, tasks, tasks, params)
    noise = _softplus(params.raw_noise)[tasks]
    L = _cholesky(K + torch.diag(JITTER + noise))
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return -0.5 * ((z * z).sum() + logdet)


def fit_mogp_hypers(
    gram: torch.Tensor, tasks: torch.Tensor, y: torch.Tensor, num_tasks: int,
    steps: int = 300,
) -> tuple[MOGPParams, torch.Tensor]:
    """Maximize the MLL over the three (T,) parameters with one Adam from
    w = 1, raw_v = 0, raw_noise = -1.5. Returns the parameters and the
    losses (-MLL) taken before each step."""
    dev = gram.device
    gram = gram.detach().to(torch.float32)
    y = y.detach().to(torch.float32).reshape(-1)
    tasks = tasks.to(torch.int64)
    raw = [
        torch.ones((num_tasks,), dtype=torch.float32, device=dev),
        torch.zeros((num_tasks,), dtype=torch.float32, device=dev),
        torch.full((num_tasks,), -1.5, dtype=torch.float32, device=dev),
    ]
    for p in raw:
        p.requires_grad_(True)
    opt = torch.optim.Adam(raw, lr=0.05)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = -_mogp_mll(MOGPParams(*raw), gram, tasks, y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return MOGPParams(*(p.detach() for p in raw)), torch.stack(losses)


class LeafMOGPSurrogate:
    """Multi-fidelity tree GP: booster forest plus fitted task and noise
    hyperparameters. Training data is (X, task index, y); task 0 is the
    target fidelity.

    ``device=None`` means the CUDA device (an error without one); pass
    ``device="cpu"`` for the CPU. The booster runs on the host whatever the
    device.
    """

    def __init__(
        self,
        domain: Domain,
        num_tasks: int = 2,
        num_boost_round: int = 50,
        max_depth: int = 3,
        node_limit: int = 64,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.domain = domain
        self.num_tasks = num_tasks
        self.num_boost_round = num_boost_round
        self.max_depth = max_depth
        self.node_limit = node_limit
        self.seed = seed
        self.scaler = Standardize()
        self._feat_types = torch.as_tensor(domain.feature_types(), device=self.device)
        self.forest: Forest | None = None  # (m, node_limit)
        self.params: MOGPParams | None = None
        # (X (N, D) float32, tasks (N,) int64, y (N,) standardized float32,
        #  leaves (N, m) int32, gram (N, N) float32)
        self.train = None

    def fit(self, X, tasks, y):
        check_matmul_precision()
        X = self.domain.transform(X)
        tasks = np.asarray(tasks, np.int64).reshape(-1)
        y_std = self.scaler(np.asarray(y, np.float64).reshape(-1), train=True)
        self.forest = fit_booster_forest(
            X, y_std, self.domain,
            num_boost_round=self.num_boost_round,
            max_depth=self.max_depth,
            node_limit=self.node_limit,
            random_state=self.seed,
        ).to(self.device)
        Xt = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        yt = torch.as_tensor(y_std, dtype=torch.float32, device=self.device)
        tt = torch.as_tensor(tasks, device=self.device)
        leaves = route_forest(self.forest, Xt, self._feat_types)
        gram = gram_from_leaves(leaves, leaves, node_limit=self.node_limit)
        self.params, _ = fit_mogp_hypers(gram, tt, yt, self.num_tasks)
        self.train = (Xt, tt, yt, leaves, gram)
        return self

    def _posterior_joint(self, X_new, tasks_new) -> tuple[torch.Tensor, torch.Tensor]:
        """Joint latent posterior ``(mu (M,), cov (M, M))`` at (X_new,
        tasks_new), in standardized units: two K1 launches (the cross Gram
        and the new points' symmetric one) and one solve."""
        check_matmul_precision()
        Xn = torch.as_tensor(self.domain.transform(X_new), dtype=torch.float32,
                             device=self.device)
        tnew = torch.as_tensor(np.asarray(tasks_new, np.int64).reshape(-1), device=self.device)
        _, t, y, leaves, gram = self.train
        new_leaves = route_forest(self.forest, Xn, self._feat_types)
        K_xX = mogp_kernel(
            gram_from_leaves(new_leaves, leaves, node_limit=self.node_limit),
            tnew, t, self.params,
        )
        K_xx = mogp_kernel(
            gram_from_leaves(new_leaves, new_leaves, node_limit=self.node_limit),
            tnew, tnew, self.params,
        )
        noise = _softplus(self.params.raw_noise)[t]
        K_XX = mogp_kernel(gram, t, t, self.params) + torch.diag(JITTER + noise)
        sol = torch.linalg.solve(K_XX, torch.cat([y[:, None], K_xX.T], dim=1))
        mu = K_xX @ sol[:, 0]
        cov = K_xx - K_xX @ sol[:, 1:]
        return mu, cov

    def predict(self, X_new, tasks_new, predict_observed: bool = True):
        """Mean and standard deviation per point, ``(M,)`` numpy each, in
        the units of y."""
        mu, cov = self._posterior_joint(X_new, tasks_new)
        var = torch.clamp_min(torch.diagonal(cov), 1e-12)
        if predict_observed:
            tnew = torch.as_tensor(np.asarray(tasks_new, np.int64).reshape(-1),
                                   device=self.device)
            var = var + _softplus(self.params.raw_noise)[tnew]
        mu, var = self.scaler.untransform_mu_var(mu.cpu().numpy(), var.cpu().numpy())
        return mu, np.sqrt(var)
