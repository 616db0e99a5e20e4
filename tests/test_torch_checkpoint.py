"""Checkpoints of the port (``utils/checkpoint.py``) against the JAX
package's, on the CPU.

Both packages write the same ``.npz`` keys, so a file written by either
loads in the other with equal arrays: a model, a BARK surrogate and a BART
surrogate, in both directions. A port surrogate restored from its own file
predicts exactly as before and resumes its generator where it stopped. The
reference's surrogates are built without a fit (their fields set from the
port's arrays), so no sampler is compiled here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bark_tpu.utils import checkpoint as jckpt

from bark_tpu_torch.benchmarks import map_benchmark
from bark_tpu_torch.fitting.bart import BARTParams
from bark_tpu_torch.fitting.params import SamplerParams
from bark_tpu_torch.forest import FOREST_FIELDS
from bark_tpu_torch.models.bart import BARTSurrogate
from bark_tpu_torch.models.surrogate import BARKSurrogate
from bark_tpu_torch.utils import checkpoint as ckpt

BART_FIELDS = {
    "samples": ("packed", "leaf_values", "sigma2"),
    "_state": ("packed", "leaf_values", "leaves", "f_total", "sigma2"),
}


@pytest.fixture(scope="module")
def bench():
    return map_benchmark("TreeFunction", dim=2, m=6, function_seed=1)


@pytest.fixture(scope="module")
def ref_domain():
    from bark_tpu.benchmarks import map_benchmark as jmap

    return jmap("TreeFunction", dim=2, m=6, function_seed=1).domain


@pytest.fixture(scope="module")
def bark(bench):
    X = bench.domain.sample(15, np.random.default_rng(0))
    params = SamplerParams(warmup_steps=5, num_samples=2, steps_per_sample=2, num_trees=6,
                           num_chains=2)
    return BARKSurrogate(bench.domain, params, seed=0, device="cpu").fit(X, bench.f(X))


@pytest.fixture(scope="module")
def bart(bench):
    X = bench.domain.sample(15, np.random.default_rng(0))
    params = BARTParams(warmup_steps=10, num_samples=4, num_trees=6, node_limit=16)
    return BARTSurrogate(bench.domain, params, seed=3, device="cpu").fit(X, bench.f(X))


def _ref_params(params):
    import dataclasses

    from bark_tpu.fitting.params import SamplerParams as JParams

    return JParams(**dataclasses.asdict(params))


def _ref_bark(ref_domain, sur):
    """A reference BARKSurrogate holding the port surrogate's fit."""
    from bark_tpu.fitting.sampler import BARKModel as JModel
    from bark_tpu.forest import Forest as JForest
    from bark_tpu.models.surrogate import BARKSurrogate as JSurrogate

    ref = JSurrogate(ref_domain, _ref_params(sur.params), seed=0)
    ref.model = JModel(JForest(*(jnp.asarray(t.numpy()) for t in sur.model.forest)),
                       jnp.asarray(sur.model.noise.numpy()), jnp.asarray(sur.model.scale.numpy()))
    ref.scaler.mean, ref.scaler.std = sur.scaler.mean, sur.scaler.std
    ref.train_data = tuple(jnp.asarray(t.numpy()) for t in sur.train_data)
    ref.train_mask = jnp.asarray(sur.train_mask.numpy())
    return ref


def _assert_model_equal(model, ref_model):
    for f in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(model.forest, f).numpy(),
                                      np.asarray(getattr(ref_model.forest, f)))
    np.testing.assert_array_equal(model.noise.numpy(), np.asarray(ref_model.noise))
    np.testing.assert_array_equal(model.scale.numpy(), np.asarray(ref_model.scale))


def test_model_checkpoint_roundtrip_keeps_the_generator(tmp_path, bark):
    gen = torch.Generator().manual_seed(42)
    torch.rand(5, generator=gen)
    path = tmp_path / "model.npz"
    ckpt.save_model(path, bark.model, generator=gen, note=1.5)
    model, state, extra = ckpt.load_model(path, device="cpu")
    _assert_model_equal(model, bark.model)
    assert float(extra["note"]) == 1.5
    resumed = torch.Generator()
    resumed.set_state(torch.as_tensor(state))
    assert torch.equal(torch.rand(4, generator=resumed), torch.rand(4, generator=gen))
    assert [p.name for p in tmp_path.iterdir()] == ["model.npz"]  # no temporary left


def test_surrogate_resumes_exactly(tmp_path, bench, bark):
    Xte = bench.domain.sample(5, np.random.default_rng(9))
    mu, std = bark.predict(Xte)
    path = tmp_path / "surrogate.npz"
    ckpt.save_surrogate(path, bark)
    fresh = ckpt.load_surrogate(path, BARKSurrogate(bench.domain, bark.params, seed=7,
                                                    device="cpu"))
    mu2, std2 = fresh.predict(Xte)
    np.testing.assert_array_equal(mu, mu2)
    np.testing.assert_array_equal(std, std2)
    assert torch.equal(fresh._generator.get_state(), bark._generator.get_state())
    X = bench.domain.sample(15, np.random.default_rng(0))
    assert fresh.fit(X, bench.f(X)).is_fitted  # warm-starts from the restored chains


def test_bark_checkpoints_load_across_the_packages(tmp_path, bench, ref_domain, bark):
    ref = _ref_bark(ref_domain, bark)
    # reference -> port
    path = tmp_path / "ref.npz"
    jckpt.save_surrogate(path, ref)
    jckpt.save_model(tmp_path / "ref_model.npz", ref.model, key=jax.random.key(5))
    fresh = ckpt.load_surrogate(path, BARKSurrogate(bench.domain, bark.params, device="cpu"))
    _assert_model_equal(fresh.model, ref.model)
    assert (fresh.scaler.mean, fresh.scaler.std) == (ref.scaler.mean, ref.scaler.std)
    for a, b in zip(fresh.train_data, ref.train_data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, state, extra = ckpt.load_model(tmp_path / "ref_model.npz", device="cpu")
    assert state is None
    np.testing.assert_array_equal(extra["rng_key"],
                                  np.asarray(jax.random.key_data(jax.random.key(5))))
    # port -> reference
    path = tmp_path / "port.npz"
    ckpt.save_surrogate(path, bark)
    from bark_tpu.models.surrogate import BARKSurrogate as JSurrogate

    back = jckpt.load_surrogate(path, JSurrogate(ref_domain, _ref_params(bark.params)))
    _assert_model_equal(bark.model, back.model)
    assert (back.scaler.mean, back.scaler.std) == (bark.scaler.mean, bark.scaler.std)
    np.testing.assert_array_equal(np.asarray(back.train_mask), bark.train_mask.numpy())


def _assert_bart_equal(sur, ref):
    for part, fields in BART_FIELDS.items():
        for f in fields:
            np.testing.assert_array_equal(getattr(getattr(sur, part), f).numpy(),
                                          np.asarray(getattr(getattr(ref, part), f)))
    assert (sur.scaler.y_min, sur.scaler.range) == (ref.scaler.y_min, ref.scaler.range)
    np.testing.assert_array_equal(np.float32(sur._noise_rate), np.asarray(ref._noise_rate))
    for a, b in zip(sur.train_data, ref.train_data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sur.train_mask.numpy(), np.asarray(ref.train_mask))


def test_bart_checkpoints_load_across_the_packages(tmp_path, bench, ref_domain, bart):
    import dataclasses

    from bark_tpu.fitting.bart import BARTParams as JParams
    from bark_tpu.fitting.bart import BARTSamples as JSamples
    from bark_tpu.fitting.bart import BARTState as JState
    from bark_tpu.models.bart import BARTSurrogate as JSurrogate

    jparams = JParams(**dataclasses.asdict(bart.params))
    # port -> port: predictions exactly as before
    Xte = bench.domain.sample(5, np.random.default_rng(9))
    path = tmp_path / "port.npz"
    ckpt.save_bart_surrogate(path, bart)
    fresh = ckpt.load_bart_surrogate(path, BARTSurrogate(bench.domain, bart.params,
                                                         device="cpu"))
    for a, b in zip(bart.predict(Xte), fresh.predict(Xte)):
        np.testing.assert_array_equal(a, b)
    # port -> reference: equal arrays, and the key of the port's seed
    back = jckpt.load_bart_surrogate(path, JSurrogate(ref_domain, jparams, seed=0))
    _assert_bart_equal(bart, back)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(back._key)),
                                  np.asarray(jax.random.key_data(jax.random.key(3))))
    # reference -> port
    ref = JSurrogate(ref_domain, jparams, seed=0)
    ref.samples = JSamples(*(jnp.asarray(getattr(bart.samples, f).numpy())
                             for f in BART_FIELDS["samples"]))
    ref._state = JState(*(jnp.asarray(getattr(bart._state, f).numpy())
                          for f in BART_FIELDS["_state"]))
    ref.scaler.y_min, ref.scaler.range = bart.scaler.y_min, bart.scaler.range
    ref._noise_rate = jnp.asarray(bart._noise_rate, jnp.float32)
    ref.train_data = tuple(jnp.asarray(t.numpy()) for t in bart.train_data)
    ref.train_mask = jnp.asarray(bart.train_mask.numpy())
    path = tmp_path / "ref.npz"
    jckpt.save_bart_surrogate(path, ref)
    loaded = ckpt.load_bart_surrogate(path, BARTSurrogate(bench.domain, bart.params,
                                                          device="cpu"))
    _assert_bart_equal(loaded, ref)


def test_loads_default_to_the_cuda_device(tmp_path, bark):
    path = tmp_path / "model.npz"
    ckpt.save_model(path, bark.model)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_model(path)
