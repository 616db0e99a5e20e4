"""Branch-free int32 bit operations for categorical bitmask splits.

Counterpart of ``bark_tpu/fitting/bits.py``: elementwise over tensors of any
shape, for masks of up to ``MAX_CATEGORIES`` categories.
"""

from __future__ import annotations

import torch

from bark_tpu_torch.forest import MAX_CATEGORIES

_NUM_BITS = MAX_CATEGORIES + 1  # enough to cover next_power_of_2 of any mask


def _bit_positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of the 32-bit two's-complement value (int32)."""
    x = x.to(torch.int32)
    bits = (x.unsqueeze(-1) >> _bit_positions(32, x.device)) & 1
    return bits.sum(-1, dtype=torch.int32)


def next_power_of_2(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two strictly greater than x (for x >= 0)."""
    x = x.to(torch.int32)
    powers = torch.ones((), dtype=torch.int32, device=x.device) << _bit_positions(
        _NUM_BITS, x.device
    )
    exponent = (powers <= x.unsqueeze(-1)).sum(-1, dtype=torch.int32)
    return torch.ones_like(exponent) << exponent


def scatter_bits(r: torch.Tensor, mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Scatter the low ``popcount(mask)`` bits of ``r`` into the set bit
    positions of ``mask`` (ascending). Returns 0 where ``c < 2`` (the
    degenerate-split indicator)."""
    idx = _bit_positions(_NUM_BITS, mask.device)
    one = torch.ones((), dtype=torch.int32, device=mask.device)
    below = (one << idx) - 1
    mask = mask.to(torch.int32)
    ranks = popcount(mask.unsqueeze(-1) & below)
    mask_bits = (mask.unsqueeze(-1) >> idx) & 1
    sel = (r.to(torch.int32).unsqueeze(-1) >> ranks) & 1
    threshold = torch.where(
        (mask_bits & sel) != 0, one << idx, torch.zeros_like(idx)
    ).sum(-1, dtype=torch.int32)
    return torch.where(c < 2, torch.zeros_like(threshold), threshold)
