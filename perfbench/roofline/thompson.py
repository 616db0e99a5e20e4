"""Operations of a Thompson-sampling search, at its logical sizes.

Beside ``counts.py`` (which it leaves as it is), in the same terms: the rows
that hold data and the leaves in use, whatever width the program packs them
at; a float multiply-add is two operations.
"""

from __future__ import annotations


def thompson_ask_flops(n: int, leaves: float, candidates: int) -> float:
    """One Thompson draw and its search, for N training rows and L leaves in
    use in the chosen forest: Z^T Z and Z^T y (2 N L^2 + 2 N L), the factor
    with inverse factor of the (L, L) matrix A (2 L^3 / 3), the weights
    theta = E^T (E Z^T y + sqrt(nu) eps) (4 L^2 + L); per candidate
    z_x^T theta (2 L)."""
    L = leaves
    build = 2.0 * n * L * L + 2.0 * n * L + 2.0 * L**3 / 3.0 + 4.0 * L * L + L
    return build + candidates * 2.0 * L
