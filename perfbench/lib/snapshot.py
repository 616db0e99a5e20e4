"""Put an object of the program back to a state it had.

A BO episode starts from the state set-up left: the strategy's and the
surrogate's attributes, whatever their names. :func:`take` copies every
attribute of the object, and of each object of the program it holds, once;
:func:`restore` writes them back, the tensors as fresh copies on their
device, and seeds every random generator anew for the episode, so episodes
do the same kind of work on different draws.
"""

from __future__ import annotations

import numpy as np
import torch

_OWN = "bark_tpu_torch"


def _own(value) -> bool:
    """A mutable object of the program (a frozen dataclass is a value)."""
    params = getattr(type(value), "__dataclass_params__", None)
    return (hasattr(value, "__dict__") and type(value).__module__.startswith(_OWN)
            and not (params is not None and params.frozen))


def take(obj, _seen=None) -> dict:
    seen = set() if _seen is None else _seen
    seen.add(id(obj))
    return {k: _copy(v, seen) for k, v in vars(obj).items()}


def _copy(v, seen):
    if isinstance(v, torch.Tensor):
        return ("tensor", v.clone())
    if isinstance(v, (torch.Generator, np.random.Generator)):
        return ("generator", v)
    if isinstance(v, np.ndarray):
        return ("array", v.copy())
    if _own(v) and id(v) not in seen:
        return ("object", v, take(v, seen))
    if isinstance(v, tuple):
        return ("tuple", type(v), [_copy(x, seen) for x in v])
    if isinstance(v, list):
        return ("list", [_copy(x, seen) for x in v])
    if isinstance(v, dict):
        return ("dict", {k: _copy(x, seen) for k, x in v.items()})
    return ("value", v)


def restore(obj, snap: dict, seed: int) -> None:
    """Write ``snap`` back into ``obj``; the n-th generator met is seeded
    from (``seed``, n)."""
    counter = iter(range(1 << 30))
    _restore(obj, snap, seed, counter)


def _restore(obj, snap, seed, counter):
    for k, v in snap.items():
        setattr(obj, k, _build(v, seed, counter))


def _build(v, seed, counter):
    kind = v[0]
    if kind == "tensor":
        return v[1].clone()
    if kind == "array":
        return v[1].copy()
    if kind == "generator":
        state = np.random.SeedSequence([seed, next(counter)]).generate_state(2, np.uint64)
        derived = int(state[0])
        if isinstance(v[1], torch.Generator):
            v[1].manual_seed(derived)
            return v[1]
        return np.random.default_rng(derived)
    if kind == "object":
        _restore(v[1], v[2], seed, counter)
        return v[1]
    if kind == "tuple":
        items = [_build(x, seed, counter) for x in v[2]]
        return v[1](*items) if hasattr(v[1], "_fields") else v[1](items)
    if kind == "list":
        return [_build(x, seed, counter) for x in v[1]]
    if kind == "dict":
        return {k: _build(x, seed, counter) for k, x in v[1].items()}
    return v[1]
