"""Bytes and operations that the work needs, at its logical sizes.

Every count here takes the sizes that hold data: chains, the rows that are
real (not the caller's padding), trees, candidates, the leaves in use. None
takes a launch shape, so a later kernel that pads otherwise, or fuses two
of these, is read against the same work. A float multiply-add is two
operations; a leaf comparison and its add (K1) are two.

K1 and K2 bounds follow ``bark_tpu_torch/benchmarks/kernel_timing.py``
(``k1_bound`` with the symmetric count of N (N + 1) / 2 pairs, ``k2_bound``)
at logical sizes. The step and iteration counts are the algorithm's, in
dense linear algebra over the leaf indicators, whatever the program
launches; PERF.md gives the formulas.
"""

from __future__ import annotations

from perfbench.roofline.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def bound_s(bytes_: float, ops: float) -> float:
    """Least seconds: the larger of bytes over HBM and operations over
    float32 peak."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def k1_work(b: int, n: int, mcols: int, m: int, symmetric: bool, masked: bool):
    """(bytes, ops) of one K1 call: the int32 leaves of each distinct input
    read once, the masks once, the float32 Gram (b, n, mcols) written once;
    a compare-and-add per pair and tree, N (N + 1) / 2 pairs when the
    Gram is symmetric."""
    reads = b * n * m + (0 if symmetric else b * mcols * m)
    if masked:
        reads += n + (0 if symmetric else mcols)
    pairs = n * (n + 1) / 2 if symmetric else n * mcols
    return 4.0 * (reads + b * n * mcols), 2.0 * b * pairs * m


def k2_work(rows) -> tuple[float, float]:
    """(bytes, ops) of one K2 call over matrices with ``rows`` data rows
    each: A read once, L and L^-1 written once; n^3 / 3 multiply-adds for
    the factor and as many for the inverse factor."""
    bytes_ = sum(3 * 4.0 * n * n for n in rows)
    ops = sum(2.0 * n**3 / 3.0 for n in rows)
    return bytes_, ops


def dense_step_flops(n: int, m: int) -> float:
    """One chain-step of the dense tier (N rows, m trees): m moves, each two
    K^-1 products with the move's rank-2 indicator and the rank-2 update of
    K^-1 (8 N^2); the refresh: the Gram (m N (N + 1)), factor and inverse
    factor of both branches of the noise move (4 N^3 / 3), K^-1 from the
    inverse factor (2 N^3 / 3) and both branches' quadratic forms (4 N^2)."""
    return 8.0 * m * n * n + m * n * (n + 1) + 2.0 * n**3 + 4.0 * n * n


def leaf_step_flops(n: int, m: int, leaves: float) -> float:
    """One chain-step of the leaf tier (N rows, m trees, L leaves in use):
    the hoist of the moves' 2m indicator columns through the leaf factor
    (Z^T W, two triangular solves, Z times it: 8 N L m + 8 L^2 m) and their
    Gram (8 N m^2); the m moves on (2m, 2m) matrices (32 m^3); the refresh:
    Z^T Z (2 N L^2), both branches' factors (2 L^3 / 3), solves (8 L^2),
    Z^T y and both residuals (6 N L) and quadratic forms (4 N)."""
    L = leaves
    return (8.0 * n * L * m + 8.0 * L * L * m + 8.0 * n * m * m + 32.0 * m**3
            + 2.0 * n * L * L + 2.0 * L**3 / 3.0 + 8.0 * L * L + 6.0 * n * L + 4.0 * n)


LEAF_TIER_FROM = 256


def tier_of(n: int) -> str:
    """The tier BARK's default lowering runs at N rows: the leaf tier (leaf
    refresh, coefficient scan) from 256 rows, the dense tier below
    (``fitting/sampler._resolve_styles`` for the default ``SamplerParams``,
    frozen here at the rows that hold data)."""
    return "leaf" if n >= LEAF_TIER_FROM else "dense"


def step_flops(tier: str, n: int, m: int, leaves: float = 0.0) -> float:
    if tier == "dense":
        return dense_step_flops(n, m)
    if tier == "leaf":
        return leaf_step_flops(n, m, leaves)
    raise ValueError(f"unknown tier {tier!r}")


def dense_ask_flops(samples: int, n: int, m: int, candidates: int) -> float:
    """The dense acquisition: per sample its Gram, factor with inverse
    factor and K^-1 y (m N (N + 1) + 2 N^3 / 3 + 2 N^2); per candidate
    and sample the agreement vector (2 m N), the mean (2 N) and the
    variance (2 N^2 + 2 N)."""
    build = m * n * (n + 1) + 2.0 * n**3 / 3.0 + 2.0 * n * n
    score = 2.0 * m * n + 2.0 * n * n + 4.0 * n
    return samples * (build + candidates * score)


def factored_ask_flops(samples: int, n: int, leaves: float, candidates: int) -> float:
    """The factored acquisition (L leaves in use a sample): per sample
    Z^T Z and Z^T y (2 N L^2 + 2 N L), the factor with inverse factor of
    the (L, L) capacitance (2 L^3 / 3) and the weights (4 L^2); per
    candidate and sample the mean (2 L) and the variance (2 L^2 + 2 L)."""
    L = leaves
    build = 2.0 * n * L * L + 2.0 * n * L + 2.0 * L**3 / 3.0 + 4.0 * L * L
    score = 2.0 * L * L + 4.0 * L
    return samples * (build + candidates * score)
