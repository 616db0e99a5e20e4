"""LeafGP: a non-Bayesian tree-kernel GP over a fitted booster forest.

Counterpart of ``bark_tpu/models/leafgp.py``. A GBDT forest
(:func:`~bark_tpu_torch.fitting.booster.fit_booster_forest`) defines a fixed
agreement kernel; only the output scale and the observation noise are
learned, by maximizing the exact GP marginal likelihood with Adam on their
softplus parameters. The Gram of the training set is constant during that
fit, so each Adam step is one Cholesky factorization, differentiated by
autograd (``torch.linalg.cholesky_ex``; a library call, as the reference's
``jnp.linalg.cholesky`` is: no Pallas kernel of the reference has a
backward).

The Gram comes from kernel K1 (``ops.gram``), and ``predict`` is the
dense posterior of :func:`~bark_tpu_torch.models.gp.forest_predict` (K1 for
K_XX and K_xX, K2 for the factor) over a batch of one forest: the model
keeps the (1, m, node_limit) forest and (1,) noise and scale of one
posterior sample, so the acquisition builders and the BO strategy take it
as they take the sampled posterior.
"""

from __future__ import annotations

import numpy as np
import torch

from bark_tpu_torch.domain import Domain
from bark_tpu_torch.fitting.booster import fit_booster_forest
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel
from bark_tpu_torch.forest import Forest, gram_from_leaves, route_forest
from bark_tpu_torch.models.surrogate import _BARKSurrogateBase
from bark_tpu_torch.ops.linalg import JITTER, check_matmul_precision


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Differentiable Cholesky that gives NaN for a matrix that is not
    positive definite (as ``jnp.linalg.cholesky`` does) instead of raising,
    and makes no host sync."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _neg_mll(params: torch.Tensor, gram: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative MLL (up to the constant) at softplus parameters
    ``(raw noise, raw scale)``."""
    noise = _softplus(params[0])
    scale = _softplus(params[1])
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    L = _cholesky(scale * gram + (JITTER + noise) * eye)
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return 0.5 * ((z * z).sum() + logdet)


def _fit_hypers(
    gram: torch.Tensor, y: torch.Tensor, steps: int = 200
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Maximize the MLL over (noise, scale) with the Gram fixed.

    ``steps`` Adam steps at learning rate 0.05 from noise 0.1 and scale 1.0
    (the reference's ``optax.adam(0.05)``: the same bias-corrected update).
    Returns ``(noise, scale, losses)``, the losses taken before each step.
    """
    gram = gram.detach().to(torch.float32)
    y = y.detach().to(torch.float32).reshape(-1)
    params = torch.tensor(
        [_inv_softplus(0.1), _inv_softplus(1.0)], dtype=torch.float32, device=gram.device,
        requires_grad=True,
    )
    opt = torch.optim.Adam([params], lr=0.05)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = _neg_mll(params, gram, y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    params = params.detach()
    return _softplus(params[0]), _softplus(params[1]), torch.stack(losses)


class LeafGPSurrogate(_BARKSurrogateBase):
    """Booster forest + scaled agreement-kernel GP with fitted scale and noise.

    ``device=None`` means the CUDA device (an error without one); pass
    ``device="cpu"`` for the CPU. The booster runs on the host whatever the
    device.
    """

    def __init__(
        self,
        domain: Domain,
        num_boost_round: int = 50,
        max_depth: int = 3,
        node_limit: int = 64,
        seed: int = 0,
        device=None,
    ):
        super().__init__(domain, SamplerParams(node_limit=node_limit),
                         predict_backend="dense", device=device)
        self.num_boost_round = num_boost_round
        self.max_depth = max_depth
        self.node_limit = node_limit
        self.seed = seed

    def fit(self, X, y):
        check_matmul_precision()
        X = self.domain.transform(X)
        y_std = self.scaler(np.asarray(y, np.float64).reshape(-1), train=True)
        forest = fit_booster_forest(
            X, y_std, self.domain,
            num_boost_round=self.num_boost_round,
            max_depth=self.max_depth,
            node_limit=self.node_limit,
            random_state=self.seed,
        ).to(self.device)
        Xt = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        yt = torch.as_tensor(y_std, dtype=torch.float32, device=self.device)
        leaves = route_forest(forest, Xt, self._feat_types, self.params.max_depth)
        gram = gram_from_leaves(leaves, leaves, node_limit=self.node_limit)
        noise, scale, _ = _fit_hypers(gram, yt)
        self.model = BARKModel(
            forest=Forest(*(t[None] for t in forest)),
            noise=noise.reshape(1),
            scale=scale.reshape(1),
        )
        self.train_data = (Xt, yt)
        self.train_mask = None
        return self

