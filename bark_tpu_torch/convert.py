"""Conversion between the reference package's objects and the port's.

Lets a test start both packages from the same state. Reference objects are
read by field name through ``numpy.asarray`` (a JAX array converts without
this module importing JAX), and numpy dicts work the same way. The
reference objects carry the chain dimension the port's state has (the
reference ``vmap``-s over chains). :func:`to_numpy` goes the other way.

``device=None`` means the CUDA device, and raises without one, as
everywhere in the port (:func:`~bark_tpu_torch.models.surrogate.resolve_device`);
pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bark_tpu_torch import constraints as port_constraints
from bark_tpu_torch import domain as port_domain
from bark_tpu_torch.fitting.bart import BARTParams, BARTSamples, BARTState
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, ChainState, KernState
from bark_tpu_torch.forest import FOREST_FIELDS, Forest, forest_from_numpy
from bark_tpu_torch.models.leafgp import LeafGPSurrogate
from bark_tpu_torch.models.mogp import LeafMOGPSurrogate, MOGPParams
from bark_tpu_torch.models.surrogate import BARKPriorSurrogate, BARKSurrogate, resolve_device
from bark_tpu_torch.optimizer.acquisition import (
    AcquisitionState,
    AcquisitionStateLR,
    AcquisitionStateMOGP,
    AcquisitionStateTS,
)
from bark_tpu_torch.parallel.tempering import PTState


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype).to(resolve_device(device))


def params_from_reference(params) -> SamplerParams:
    """A ``bark_tpu`` SamplerParams (or any dataclass with its fields)."""
    return SamplerParams(**dataclasses.asdict(params))


def forest_from_reference(forest, device=None) -> Forest:
    """A reference Forest (or dict of its fields)."""
    return forest_from_numpy(
        {k: np.asarray(_get(forest, k)) for k in FOREST_FIELDS}, resolve_device(device)
    )


def model_from_reference(model, device=None) -> BARKModel:
    """A reference BARKModel (forest, noise, scale)."""
    return BARKModel(
        forest=forest_from_reference(_get(model, "forest"), device),
        noise=_tensor(_get(model, "noise"), torch.float32, device),
        scale=_tensor(_get(model, "scale"), torch.float32, device),
    )


def chain_state_from_reference(state, device=None) -> ChainState:
    """A reference ChainState of any lowering.

    The dense refreshes and the woodbury backend: its KernState carries
    K_inv and K_logdet. The leaf tier and the ``factor`` refresh: K_inv is
    a zero-size placeholder and the K slot holds a Cholesky factor (of A in
    the leaf tier, of K under factor), the port's ``KernState.L`` (a dict
    may name it ``K`` or ``L``; without a non-empty ``K_inv`` it reads as a
    factor). Chol backend: K_inv and K_logdet are both zero-size
    placeholders and the K slot holds the kernel matrix, the port's
    ``KernState.K``. The subspaces (``subspace_mode="carry"``) become
    ``ChainState.subspaces``; the reference's zero-size placeholder under
    "walk" (or a missing field) becomes None.
    """
    f32 = torch.float32
    kern = _get(state, "kern")
    fields = {
        k: np.asarray(v) for k, v in (kern if isinstance(kern, dict) else kern._asdict()).items()
    }
    if not fields["K_logdet"].size:
        kern = KernState(K_inv=None, K_logdet=None, K=_tensor(fields["K"], f32, device))
    elif fields.get("K_inv", np.empty(0)).size:
        kern = KernState(K_inv=_tensor(fields["K_inv"], f32, device),
                         K_logdet=_tensor(fields["K_logdet"], f32, device))
    else:
        L = fields["L"] if "L" in fields else fields["K"]
        kern = KernState(K_inv=None, K_logdet=_tensor(fields["K_logdet"], f32, device),
                         L=_tensor(L, f32, device))
    has_subs = "subspaces" in state if isinstance(state, dict) else hasattr(state, "subspaces")
    subs = np.asarray(_get(state, "subspaces")) if has_subs else None
    return ChainState(
        forest=forest_from_reference(_get(state, "forest"), device),
        leaves=_tensor(_get(state, "leaves"), torch.int32, device),
        noise=_tensor(_get(state, "noise"), f32, device),
        scale=_tensor(_get(state, "scale"), f32, device),
        kern=kern,
        mll=_tensor(_get(state, "mll"), f32, device),
        subspaces=None if subs is None or not subs.size else _tensor(subs, f32, device),
    )


def domain_from_reference(domain) -> port_domain.Domain:
    """A reference Domain: inputs, outputs and constraints are rebuilt as the
    port's classes of the same name from their dataclass fields."""

    def rebuild(obj, module):
        cls = getattr(module, type(obj).__name__)
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})

    return port_domain.Domain(
        [rebuild(f, port_domain) for f in domain.inputs],
        outputs=[rebuild(o, port_domain) for o in domain.outputs],
        constraints=[rebuild(c, port_constraints) for c in domain.constraints],
    )


def pt_state_from_reference(state, device=None) -> PTState:
    """A reference PTState, chains with a leading (R,) replica axis and (R,)
    betas, as the port's one ladder: (R,) chain rows and (1, R) betas."""
    betas = _tensor(_get(state, "betas"), torch.float32, device)
    return PTState(chain_state_from_reference(_get(state, "chains"), device), betas[None])


def surrogate_from_reference(surrogate, device=None):
    """A fitted reference BARKSurrogate or BARKPriorSurrogate as the port's
    class of the same name: its domain, params, options, posterior (or
    prior) samples, y scaler and the padded training data with the row
    mask, so that both packages predict and build acquisitions from the same
    state."""
    common = dict(
        predict_backend=surrogate.predict_backend, device=device,
    )
    domain = domain_from_reference(surrogate.domain)
    params = params_from_reference(surrogate.params)
    if type(surrogate).__name__ == "BARKPriorSurrogate":
        port = BARKPriorSurrogate(domain, params, num_samples=surrogate.num_samples, **common)
    else:
        port = BARKSurrogate(
            domain, params, fit_style=surrogate.fit_style,
            num_replicas=surrogate.num_replicas, beta_min=surrogate.beta_min, **common,
        )
    dev = port.device
    port.model = model_from_reference(surrogate.model, dev)
    port.scaler.mean, port.scaler.std = surrogate.scaler.mean, surrogate.scaler.std
    train_x, train_y = surrogate.train_data
    port.train_data = (
        _tensor(train_x, torch.float32, dev), _tensor(train_y, torch.float32, dev)
    )
    port.train_mask = _tensor(surrogate.train_mask, torch.float32, dev)
    return port


def leafgp_from_reference(surrogate, device=None) -> LeafGPSurrogate:
    """A fitted reference LeafGPSurrogate as the port's: its domain, booster
    options, (1, m, node_limit) forest, (1,) noise and scale, y scaler and
    training data, so that both packages predict from the same state."""
    port = LeafGPSurrogate(
        domain_from_reference(surrogate.domain),
        num_boost_round=surrogate.num_boost_round, max_depth=surrogate.max_depth,
        node_limit=surrogate.node_limit, seed=surrogate.seed, device=device,
    )
    dev = port.device
    port.model = model_from_reference(surrogate.model, dev)
    port.scaler.mean, port.scaler.std = surrogate.scaler.mean, surrogate.scaler.std
    train_x, train_y = surrogate.train_data
    port.train_data = (
        _tensor(train_x, torch.float32, dev), _tensor(train_y, torch.float32, dev)
    )
    port.train_mask = None
    return port


def mogp_from_reference(mogp, device=None) -> LeafMOGPSurrogate:
    """A fitted reference LeafMOGPSurrogate as the port's: its domain,
    options, (m, node_limit) forest, MOGPParams, the ``train`` tuple (X,
    tasks, y, leaves, Gram) and the y scaler."""
    port = LeafMOGPSurrogate(
        domain_from_reference(mogp.domain), num_tasks=mogp.num_tasks,
        num_boost_round=mogp.num_boost_round, max_depth=mogp.max_depth,
        node_limit=mogp.node_limit, seed=mogp.seed, device=device,
    )
    dev = port.device
    f32 = torch.float32
    port.forest = forest_from_reference(mogp.forest, dev)
    port.params = MOGPParams(*(_tensor(_get(mogp.params, k), f32, dev)
                               for k in MOGPParams._fields))
    X, tasks, y, leaves, gram = mogp.train
    port.train = (_tensor(X, f32, dev), _tensor(tasks, torch.int64, dev), _tensor(y, f32, dev),
                  _tensor(leaves, torch.int32, dev), _tensor(gram, f32, dev))
    port.scaler.mean, port.scaler.std = mogp.scaler.mean, mogp.scaler.std
    return port


def acquisition_state_from_reference(state, device=None):
    """A reference AcquisitionState, AcquisitionStateLR, AcquisitionStateTS
    or AcquisitionStateMOGP (told apart by their fields) as the port's."""
    f32 = torch.float32
    fields = state if isinstance(state, dict) else state._asdict()
    forest = forest_from_reference(fields["forest"], device)
    rest = {
        k: _tensor(v, torch.int32 if k == "train_leaves" else f32, device)
        for k, v in fields.items() if k != "forest"
    }
    if "k_scale" in rest:
        return AcquisitionStateMOGP(forest=forest, **rest)
    if "K_inv" in rest:
        return AcquisitionState(forest=forest, **rest)
    if "beta" in rest:
        return AcquisitionStateLR(forest=forest, **rest)
    return AcquisitionStateTS(forest=forest, **rest)


def bart_params_from_reference(params) -> BARTParams:
    """A ``bark_tpu`` BARTParams (or any dataclass with its fields)."""
    return BARTParams(**dataclasses.asdict(params))


def bart_state_from_reference(state, device=None) -> BARTState:
    """A reference BARTState of ``run_bart_sampler`` (chains leading)."""
    f32, i32 = torch.float32, torch.int32
    return BARTState(
        packed=_tensor(_get(state, "packed"), i32, device),
        leaf_values=_tensor(_get(state, "leaf_values"), f32, device),
        leaves=_tensor(_get(state, "leaves"), i32, device),
        f_total=_tensor(_get(state, "f_total"), f32, device),
        sigma2=_tensor(_get(state, "sigma2"), f32, device),
    )


def bart_samples_from_reference(samples, device=None) -> BARTSamples:
    """Reference BARTSamples, (num_chains, num_samples) leading."""
    return BARTSamples(
        packed=_tensor(_get(samples, "packed"), torch.int32, device),
        leaf_values=_tensor(_get(samples, "leaf_values"), torch.float32, device),
        sigma2=_tensor(_get(samples, "sigma2"), torch.float32, device),
    )


def to_numpy(obj):
    """A port object (Forest, BARKModel, ChainState, ...) as nested dicts of
    numpy arrays keyed by field name, the layout the functions above read
    (a field that is None, such as the other tier's kernel carry, is left
    out)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return {k: to_numpy(v) for k, v in obj._asdict().items() if v is not None}
