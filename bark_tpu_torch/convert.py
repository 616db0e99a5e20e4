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

from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.fitting.sampler import BARKModel, ChainState, KernState
from bark_tpu_torch.forest import FOREST_FIELDS, Forest, forest_from_numpy


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


def to_numpy(obj):
    """A port object (Forest, BARKModel, ChainState, ...) as nested dicts of
    numpy arrays keyed by field name, the layout the functions above read
    (a field that is None, such as the other tier's kernel carry, is left
    out)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return {k: to_numpy(v) for k, v in obj._asdict().items() if v is not None}
