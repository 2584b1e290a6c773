"""Base error-bound policy: the uniform subset.

The uniform policy (one global ``cfg.eb``) compresses through the
scalar path.  Per-(window, tile) policies (the JAX package's
``TilePolicy`` and the v3 adaptive container) are not ported yet
(ROADMAP Queue 1 item 5) and are refused.
"""
from __future__ import annotations

import dataclasses


class DegenerateRangeError(ValueError):
    """``mode="rel"`` on a (near-)constant field: the value range is
    (numerically) zero, so a relative bound carries no signal."""


# a range this many orders below the value magnitude carries no signal
# a *relative* bound could meaningfully scale to
_REL_RANGE_FLOOR = 1e-12


def check_relative_range(rng: float, max_abs: float) -> float:
    """Validate the value range a ``mode="rel"`` bound scales with;
    raises :class:`DegenerateRangeError`.  Returns the range."""
    if rng <= max_abs * _REL_RANGE_FLOOR:
        raise DegenerateRangeError(
            f"mode='rel' on a (near-)constant field: value range {rng!r} "
            f"vs magnitude {max_abs!r}; a relative error bound is "
            "meaningless here -- use mode='abs' with an explicit bound")
    return rng


@dataclasses.dataclass(frozen=True)
class UniformPolicy:
    """The default policy: one global base bound (``cfg.eb``)."""

    @property
    def is_uniform(self) -> bool:
        return True

    def spec(self):
        return None


def normalize(policy):
    """``None`` for the uniform scalar path; any other policy raises
    NotImplementedError (adaptive bounds are not ported)."""
    # duck-typed so the JAX package's UniformPolicy is accepted too
    if policy is None or policy == "uniform" \
            or getattr(policy, "is_uniform", False) is True:
        return None
    raise NotImplementedError(
        "per-tile eb policies are not ported to repro_torch yet "
        "(ROADMAP Queue 1 item 5: adaptive bounds)")
