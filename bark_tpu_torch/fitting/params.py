"""Static sampler configuration (copy of ``bark_tpu.fitting.params``).

The port carries its own copy because importing anything from ``bark_tpu``
imports JAX. Fields, defaults, validation and ``proposal_weights`` are
identical (held equal by ``tests/test_torch_forest.py``), so
``SamplerParams(**dataclasses.asdict(reference_params))`` rebuilds a
reference instance here. The lowering knobs (``kernel_backend``,
``scan_style``, ``refresh_style``, ``hot_style``, ``subspace_mode``, ...)
are validated the same way, and the port's sampler runs every value
(``fitting.sampler``; ``_resolve_styles`` resolves ``auto`` by padded N as
the reference does).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from bark_tpu_torch.forest import DEFAULT_MAX_DEPTH, DEFAULT_NODE_LIMIT


@dataclass(frozen=True)
class SamplerParams:
    # MCMC run parameters
    warmup_steps: int = 50
    num_samples: int = 5
    steps_per_sample: int = 10
    num_chains: int = 1

    # node depth prior alpha * (1 + depth)^-beta
    alpha: float = 0.95
    beta: float = 2.0
    num_trees: int = 50

    # noise and scale proposal parameters
    use_softplus_transform: bool = True
    sample_scale: bool = False
    gamma_prior_shape: float = 1.5
    gamma_prior_rate: float = 5.0

    # transition type probabilities
    grow_prune_weight: float = 0.5
    change_weight: float = 1.0

    # Hastings ratio of the softplus noise/scale walk: "correct" keeps only
    # the Jacobian term; "reference" replays the original formula
    q_ratio_style: str = "correct"

    # fixed-shape caps
    node_limit: int = DEFAULT_NODE_LIMIT
    max_depth: int = DEFAULT_MAX_DEPTH

    # the lowering (fitting/sampler.py describes each one):
    #   kernel_backend: "rank1" (rank-2 updates of a carry refreshed exactly
    #     once a step), "chol" (K itself, factored every move; the
    #     drift-free oracle), "woodbury" (rank-L updates of K^-1 by the
    #     moved tree's leaf indicators, the original BARK algorithm);
    #   subspace_mode: "walk" (the chosen node's subspace by its parent
    #     chain) or "carry" (every node's subspace kept in the state);
    #   refresh_style: "auto", "pair", "batched", "onesolve", "factor" or
    #     "leaf" (factor and leaf need the coeff scan);
    #   scan_style: "auto", "plain", "aug", "lowrank" or "coeff";
    #   leaf_budget: the leaf tier's slot count R (0: by padded N).
    # hot_style, scan_unroll, chol_block, chol_impl and gram_dtype choose
    # among the reference's XLA lowerings of the same arithmetic; they are
    # validated and not read (the proposal batch has one form, K1's counts
    # are exact for either one-hot dtype, K2 factors any block, the move
    # loop is a Python loop).
    kernel_backend: str = "rank1"
    subspace_mode: str = "walk"
    hot_style: str = "walk_select"
    refresh_style: str = "auto"
    scan_style: str = "auto"
    leaf_budget: int = 0
    scan_unroll: int = 1
    chol_block: int = -1
    chol_impl: str = "auto"
    gram_dtype: str = "f32"

    _ALLOWED_MODES = {
        "kernel_backend": ("rank1", "chol", "woodbury"),
        "subspace_mode": ("walk", "carry"),
        "hot_style": ("walk_select", "scatter", "select", "doubling"),
        "refresh_style": (
            "auto", "pair", "batched", "onesolve", "factor", "leaf"
        ),
        "scan_style": ("plain", "aug", "lowrank", "coeff", "auto"),
        "gram_dtype": ("f32", "bf16"),
        "chol_impl": ("auto", "xla", "pallas"),
        "q_ratio_style": ("correct", "reference"),
    }

    def __post_init__(self):
        for name, allowed in self._ALLOWED_MODES.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"SamplerParams.{name}={value!r}: must be one of {allowed}"
                )
        if self.refresh_style in ("factor", "leaf") and self.scan_style not in (
            "coeff",
            "auto",
        ):
            raise ValueError(
                f'refresh_style="{self.refresh_style}" requires '
                'scan_style="coeff" (or "auto")'
            )
        if not (isinstance(self.leaf_budget, int) and self.leaf_budget >= 0):
            raise ValueError(
                f"SamplerParams.leaf_budget={self.leaf_budget!r}: must be 0 "
                "(auto) or a positive slot count"
            )
        if not (isinstance(self.chol_block, int) and self.chol_block >= -1):
            raise ValueError(
                f"SamplerParams.chol_block={self.chol_block!r}: must be -1 "
                "(auto), 0 (XLA), or a positive panel size"
            )
        if not (isinstance(self.scan_unroll, int) and self.scan_unroll >= 1):
            raise ValueError(
                f"SamplerParams.scan_unroll={self.scan_unroll!r}: must be a "
                "positive int"
            )

    @property
    def proposal_weights(self) -> tuple[float, float, float]:
        """Normalized (grow, prune, change) probabilities."""
        p = (self.grow_prune_weight, self.grow_prune_weight, self.change_weight)
        s = sum(p)
        return (p[0] / s, p[1] / s, p[2] / s)

    def with_(self, **kwargs) -> "SamplerParams":
        return replace(self, **kwargs)
