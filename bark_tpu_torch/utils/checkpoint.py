"""Checkpoint and resume for sampler state and surrogates.

Counterpart of ``bark_tpu/utils/checkpoint.py``, with the same ``.npz``
keys and the same atomic write (a temporary file in the target's directory,
then a rename), so that a file written by either package loads in the other
with equal arrays. Two differences, both about the generator (ROADMAP O11):

  - a reference file's JAX key (``rng_key``) has no torch counterpart: it
    comes back as its raw uint32 words, in ``extra["rng_key"]``;
  - the port saves a ``torch.Generator``'s state under its own key,
    ``torch_generator_state``, which the reference ignores; a BART file
    also gets the ``rng_key`` the reference's loader needs, the key of the
    surrogate's seed.

Loads return tensors on the device asked for (``device=None``: the CUDA
device), as the port's entry points do.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from bark_tpu_torch.fitting.sampler import BARKModel
from bark_tpu_torch.forest import FOREST_FIELDS, forest_from_numpy
from bark_tpu_torch.models.surrogate import resolve_device

GENERATOR_KEY = "torch_generator_state"


def _atomic_savez(path: Path, **arrays):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # the suffix must be ".npz": numpy appends it otherwise, which would
    # leave the temp handle empty and the rename would move a 0-byte file
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _generator_state(generator: torch.Generator) -> np.ndarray:
    return generator.get_state().numpy()


def _set_generator_state(generator: torch.Generator, state: np.ndarray) -> None:
    generator.set_state(torch.as_tensor(np.asarray(state, np.uint8)))


def save_model(path, model: BARKModel, generator: torch.Generator | None = None, **extra):
    """Snapshot a model triple (and a generator's state, and metadata)."""
    arrays = {f"forest_{f}": _np(getattr(model.forest, f)) for f in FOREST_FIELDS}
    arrays["noise"] = _np(model.noise)
    arrays["scale"] = _np(model.scale)
    if generator is not None:
        arrays[GENERATOR_KEY] = _generator_state(generator)
    for k, v in extra.items():
        arrays[f"extra_{k}"] = _np(v)
    _atomic_savez(path, **arrays)


def load_model(path, device=None) -> tuple[BARKModel, np.ndarray | None, dict]:
    """Restore (model, the saved generator state or None, extra metadata).

    A reference file's ``rng_key`` comes back as ``extra["rng_key"]``."""
    device = resolve_device(device)
    with np.load(path) as data:
        forest = forest_from_numpy({f: data[f"forest_{f}"] for f in FOREST_FIELDS}, device)
        model = BARKModel(forest, _f32(data["noise"], device), _f32(data["scale"], device))
        state = data[GENERATOR_KEY] if GENERATOR_KEY in data else None
        extra = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}
        if "rng_key" in data:
            extra["rng_key"] = data["rng_key"]
    return model, state, extra


def save_surrogate(path, surrogate) -> None:
    """Checkpoint a fitted BARK surrogate (model, scaler, train data, the
    generator's state)."""
    train_x, train_y = surrogate.train_data
    save_model(
        path,
        surrogate.model,
        generator=surrogate._generator,
        scaler_mean=surrogate.scaler.mean,
        scaler_std=surrogate.scaler.std,
        train_x=_np(train_x),
        train_y=_np(train_y),
        train_mask=_np(surrogate.train_mask),
    )


def load_surrogate(path, surrogate):
    """Restore a checkpoint into a freshly constructed surrogate (on its
    device); its generator takes the saved state where there is one."""
    dev = surrogate.device
    model, state, extra = load_model(path, dev)
    surrogate.model = model
    if state is not None:
        _set_generator_state(surrogate._generator, state)
    surrogate.scaler.mean = float(extra["scaler_mean"])
    surrogate.scaler.std = float(extra["scaler_std"])
    surrogate.train_data = (_f32(extra["train_x"], dev), _f32(extra["train_y"], dev))
    surrogate.train_mask = _f32(extra["train_mask"], dev)
    return surrogate


def save_bart_surrogate(path, surrogate) -> None:
    """Checkpoint a fitted BART surrogate: posterior draws, the chains'
    final states (for warm-started refits), the min-max y scaler, the noise
    prior's rate, the padded train data and its mask, the generator's state."""
    s, st = surrogate.samples, surrogate._state
    train_x, train_y = surrogate.train_data
    arrays = {
        "samples_packed": _np(s.packed),
        "samples_leaf_values": _np(s.leaf_values),
        "samples_sigma2": _np(s.sigma2),
        "state_packed": _np(st.packed),
        "state_leaf_values": _np(st.leaf_values),
        "state_leaves": _np(st.leaves),
        "state_f_total": _np(st.f_total),
        "state_sigma2": _np(st.sigma2),
        "scaler_y_min": np.asarray(surrogate.scaler.y_min),
        "scaler_range": np.asarray(surrogate.scaler.range),
        "noise_rate": np.asarray(surrogate._noise_rate, np.float32),
        "train_x": _np(train_x),
        "train_y": _np(train_y),
        "train_mask": _np(surrogate.train_mask),
        GENERATOR_KEY: _generator_state(surrogate._generator),
        # the reference's loader needs a JAX key: that of the surrogate's
        # seed (jax.random.key(seed) holds the words (0, seed))
        "rng_key": np.array([0, surrogate._generator.initial_seed() & 0xFFFFFFFF], np.uint32),
    }
    _atomic_savez(path, **arrays)


def load_bart_surrogate(path, surrogate):
    """Restore a BART checkpoint into a freshly constructed surrogate (on
    its device). A reference file's ``rng_key`` stays unused: the
    surrogate's generator keeps its own state."""
    from bark_tpu_torch.fitting.bart import BARTSamples, BARTState

    dev = surrogate.device
    with np.load(path) as data:
        f = lambda k: _f32(data[k], dev)  # noqa: E731
        i = lambda k: torch.as_tensor(np.asarray(data[k], np.int32), device=dev)  # noqa: E731
        surrogate.samples = BARTSamples(
            i("samples_packed"), f("samples_leaf_values"), f("samples_sigma2")
        )
        surrogate._state = BARTState(
            i("state_packed"), f("state_leaf_values"), i("state_leaves"),
            f("state_f_total"), f("state_sigma2"),
        )
        surrogate.scaler.y_min = float(data["scaler_y_min"])
        surrogate.scaler.range = float(data["scaler_range"])
        surrogate._noise_rate = float(data["noise_rate"])
        surrogate.train_data = (f("train_x"), f("train_y"))
        surrogate.train_mask = f("train_mask")
        if GENERATOR_KEY in data:
            _set_generator_state(surrogate._generator, data[GENERATOR_KEY])
    return surrogate
