"""Conversion between the reference package's objects and the port's.

Lets a test start both packages from the same state. Reference objects are
read by field name through ``numpy.asarray`` (a JAX array converts without
this module importing JAX), and numpy dicts work the same way. The
reference objects carry the chain dimension the port's state has (the
reference ``vmap``-s over chains). :func:`to_numpy` goes the other way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bark_tpu_torch import constraints as port_constraints
from bark_tpu_torch import domain as port_domain
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, ChainState, KernState
from bark_tpu_torch.forest import FOREST_FIELDS, Forest, forest_from_numpy
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.optimizer.acquisition import (
    AcquisitionState,
    AcquisitionStateLR,
    AcquisitionStateTS,
)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype).to(device)


def params_from_reference(params) -> SamplerParams:
    """A ``bark_tpu`` SamplerParams (or any dataclass with its fields)."""
    return SamplerParams(**dataclasses.asdict(params))


def forest_from_reference(forest, device=None) -> Forest:
    """A reference Forest (or dict of its fields)."""
    return forest_from_numpy({k: np.asarray(_get(forest, k)) for k in FOREST_FIELDS}, device)


def model_from_reference(model, device=None) -> BARKModel:
    """A reference BARKModel (forest, noise, scale)."""
    return BARKModel(
        forest=forest_from_reference(_get(model, "forest"), device),
        noise=_tensor(_get(model, "noise"), torch.float32, device),
        scale=_tensor(_get(model, "scale"), torch.float32, device),
    )


def chain_state_from_reference(state, device=None) -> ChainState:
    """A reference ChainState of either tier (the subspace placeholder is
    not read).

    Dense tier: its KernState carries K_inv and K_logdet. Leaf tier: K_inv
    is a zero-size placeholder and the K slot holds the factor L of A, the
    port's ``KernState.L`` (a dict may name it ``K`` or ``L``; without a
    non-empty ``K_inv`` it reads as the leaf tier).
    """
    f32 = torch.float32
    kern = _get(state, "kern")
    fields = {
        k: np.asarray(v) for k, v in (kern if isinstance(kern, dict) else kern._asdict()).items()
    }
    K_logdet = _tensor(fields["K_logdet"], f32, device)
    if fields.get("K_inv", np.empty(0)).size:
        kern = KernState(K_inv=_tensor(fields["K_inv"], f32, device), K_logdet=K_logdet)
    else:
        L = fields["L"] if "L" in fields else fields["K"]
        kern = KernState(K_inv=None, K_logdet=K_logdet, L=_tensor(L, f32, device))
    return ChainState(
        forest=forest_from_reference(_get(state, "forest"), device),
        leaves=_tensor(_get(state, "leaves"), torch.int32, device),
        noise=_tensor(_get(state, "noise"), f32, device),
        scale=_tensor(_get(state, "scale"), f32, device),
        kern=kern,
        mll=_tensor(_get(state, "mll"), f32, device),
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


def surrogate_from_reference(surrogate, device=None) -> BARKSurrogate:
    """A fitted reference BARKSurrogate: its domain, params, posterior
    samples, y scaler and the padded training data with the row mask, so
    that both packages predict and build acquisitions from the same state."""
    port = BARKSurrogate(
        domain_from_reference(surrogate.domain),
        params_from_reference(surrogate.params),
        predict_backend=surrogate.predict_backend,
        device=device,
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


def acquisition_state_from_reference(state, device=None):
    """A reference AcquisitionState, AcquisitionStateLR or
    AcquisitionStateTS (told apart by their fields) as the port's."""
    f32 = torch.float32
    fields = state if isinstance(state, dict) else state._asdict()
    forest = forest_from_reference(fields["forest"], device)
    rest = {
        k: _tensor(v, torch.int32 if k == "train_leaves" else f32, device)
        for k, v in fields.items() if k != "forest"
    }
    if "K_inv" in rest:
        return AcquisitionState(forest=forest, **rest)
    if "beta" in rest:
        return AcquisitionStateLR(forest=forest, **rest)
    return AcquisitionStateTS(forest=forest, **rest)


def to_numpy(obj):
    """A port object (Forest, BARKModel, ChainState, ...) as nested dicts of
    numpy arrays keyed by field name, the layout the functions above read
    (a field that is None, such as the other tier's kernel carry, is left
    out)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return {k: to_numpy(v) for k, v in obj._asdict().items() if v is not None}
