"""PyTorch / CUDA port of the BARK forest-MCMC sampler.

A second package beside :mod:`bark_tpu` (the JAX reference, which it never
imports). Module names mirror the reference so each counterpart is easy to
find: ``forest``, ``domain``, ``fitting.{params,bits,traversal,proposals,
noise_scale,sampler}``, ``ops.linalg`` and ``benchmarks.tree_function``.

State is batched by construction: every sampler tensor carries a leading
chain dimension where the reference ``vmap``-ed over chains, and every
sequential ``lax.scan`` is a Python loop. Randomness comes from explicit
``torch.Generator`` objects (:func:`fitting.sampler.draw_step`).

The two kernels the reference wrote in Pallas for the TPU are hand-written
CUDA C++ for Hopper (``csrc/``), compiled with ``nvcc`` at first use
(``ops/_build.py``):

  - ``ops.gram``: leaf-agreement counts (replaces ``ops/pallas_gram.py``);
  - ``ops.chol``: batched Cholesky with its inverse (replaces
    ``ops/pallas_chol.py``).

Each has a plain PyTorch version beside it, which is what runs for tensors
on the CPU; a CUDA tensor always goes through the kernel.

This package covers the dense tier of the sampler (padded N < 256) with the
shipped default lowering; see ``fitting.sampler._resolve_styles``.
"""
