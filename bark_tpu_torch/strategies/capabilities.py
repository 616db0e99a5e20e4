"""Construction-time strategy capability declarations and validation.

Copy of ``bark_tpu/strategies/capabilities.py`` over the port's own domain
and constraint classes. Every strategy class carries
``SUPPORTED_FEATURES`` / ``SUPPORTED_CONSTRAINTS`` tuples and calls
:func:`validate_domain` in ``__init__``: handing a strategy a domain it
cannot optimize raises at once with a clear message instead of surfacing
later as a deep failure.

Subclass semantics are intentional: declaring
``LinearInequalityConstraint`` also admits ``LinearEqualityConstraint``
(its subclass); a strategy that lowers the inequality form handles the
equality form through the same machinery.
"""

from __future__ import annotations

from bark_tpu_torch.constraints import Constraint
from bark_tpu_torch.domain import Domain

#: sentinel: every feature/constraint type is supported (rejection-sampling
#: and penalty-search based strategies are type-agnostic)
ALL = None


def validate_domain(strategy_cls: type, domain: Domain) -> None:
    """Raise ``ValueError`` if ``domain`` uses a feature or constraint type
    the strategy does not declare support for.

    A strategy class declares class attributes
    ``SUPPORTED_FEATURES: tuple[type, ...] | None`` and
    ``SUPPORTED_CONSTRAINTS: tuple[type, ...] | None``; ``None`` (the
    :data:`ALL` sentinel) means unrestricted. A missing attribute also
    means unrestricted, so external strategy classes keep working.
    """
    name = strategy_cls.__name__
    feats = getattr(strategy_cls, "SUPPORTED_FEATURES", ALL)
    cons = getattr(strategy_cls, "SUPPORTED_CONSTRAINTS", ALL)
    if feats is not ALL:
        for f in domain.inputs:
            if not isinstance(f, tuple(feats)):
                raise ValueError(
                    f"{name} does not support {type(f).__name__} inputs "
                    f"(feature {f.key!r}); supported feature types: "
                    f"{[t.__name__ for t in feats]}"
                )
    constraints = getattr(domain, "constraints", ()) or ()
    if cons is not ALL:
        for c in constraints:
            if not isinstance(c, Constraint):
                raise ValueError(
                    f"{name}: domain constraint {c!r} is not a "
                    "bark_tpu_torch.constraints.Constraint"
                )
            if not isinstance(c, tuple(cons)):
                supported = (
                    [t.__name__ for t in cons] if cons else "none"
                )
                raise ValueError(
                    f"{name} does not support "
                    f"{type(c).__name__} constraints; supported: {supported}"
                )


def supports_constraint(strategy_cls: type, constraint_type: type) -> bool:
    """Does the strategy declare support for this constraint type?"""
    cons = getattr(strategy_cls, "SUPPORTED_CONSTRAINTS", ALL)
    return cons is ALL or any(issubclass(constraint_type, t) for t in cons)


def supports_feature(strategy_cls: type, feature_type: type) -> bool:
    """Does the strategy declare support for this feature type?"""
    feats = getattr(strategy_cls, "SUPPORTED_FEATURES", ALL)
    return feats is ALL or any(issubclass(feature_type, t) for t in feats)
