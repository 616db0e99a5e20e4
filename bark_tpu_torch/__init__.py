"""PyTorch / CUDA port of BARK: the forest-MCMC sampler, the BO loop on it and
its baselines.

A second package beside :mod:`bark_tpu` (the JAX reference, which it never
imports). Module names mirror the reference so each counterpart is easy to
find: ``forest``, ``domain``, ``constraints``, ``fitting.{params,bits,
traversal,proposals,noise_scale,sampler}``, ``ops.linalg``,
``models.{gp,surrogate}``, ``optimizer.{acquisition,search}``,
``strategies.{capabilities,tree_kernel,baselines}``,
``utils.{build,diagnostics,metrics,timer}``, ``fitting.bart`` /
``models.bart`` and ``benchmarks`` (``map_benchmark``, the objectives, the
``study`` and ``regression`` runners); ``convert`` turns reference objects
into the port's.

State is batched by construction: every sampler tensor carries a leading
chain dimension where the reference ``vmap``-ed over chains, every
prediction and acquisition tensor a leading dimension S = chains x samples
where it ``vmap``-ed over posterior samples, and every sequential
``lax.scan`` is a Python loop. Randomness comes from explicit
``torch.Generator`` objects, drawn into records that the functions take as
arguments (:func:`fitting.sampler.draw_step`,
:func:`optimizer.search.draw_search`,
:func:`optimizer.acquisition.draw_acquisition_ts`).

The two kernels the reference wrote in Pallas for the TPU are hand-written
CUDA C++ for Hopper (``csrc/``), compiled with ``nvcc`` at first use
(``ops/_build.py``):

  - ``ops.gram``: leaf-agreement counts (replaces ``ops/pallas_gram.py``);
  - ``ops.chol``: batched Cholesky with its inverse (replaces
    ``ops/pallas_chol.py``).

Each has a plain PyTorch version beside it, which is what runs for tensors
on the CPU; a CUDA tensor always goes through the kernel.

The package covers

  - the sampler in both of its tiers with the shipped default lowering (the
    dense tier below padded N = 256, the leaf tier from there on; see
    ``fitting.sampler._resolve_styles``);
  - the BO loop on it: ``BARKSurrogate`` (fit with warm starts, dense and
    leaf-space predict), the dense, factored and Thompson acquisitions, the
    candidate search with leaf-box centering and constraints, and
    ``TreeKernelStrategy`` / ``make_strategy``. These entry points take numpy
    arrays and a ``device`` (None = the CUDA device; the CPU only when asked
    for);
  - the baselines: native BART, grid UCB, the relaxed GP, the booster-forest
    surrogates, and the BO-study and regression runners.
"""
