"""Per-unit adaptive base error bounds (the JAX package's EbPolicy).

The base error bound is one global scalar (``cfg.eb``) unless the
config carries a :class:`TilePolicy`: per-(window, tile) bounds over
the policy's own grid, resolved into per-vertex base-bound planes
before the derive stage.

* the per-vertex base bound is the MIN over policy units whose
  one-cell / one-frame inflated owned box covers the vertex;
* the global plan parameters (tau, xi_unit, scale) derive from the
  policy's MAXIMUM bound: adaptivity only clamps per-vertex bounds
  DOWN, so the quantization grid stays global and the decode path is
  unchanged (a bound below xi_unit forces the vertex lossless);
* FC = 0 holds under any policy: the verify fixpoint forces every
  violating vertex lossless whatever its base bound.

The resolution is host numpy float64, as in the reference, so the
per-vertex caps ``floor(bound * scale)`` round exactly as there.  The
uniform policy (``None``, ``"uniform"``, :class:`UniformPolicy`) runs
the scalar code path and writes the pre-policy (version 2) container.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np


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


@dataclasses.dataclass(frozen=True)
class TilePolicy:
    """Explicit per-(window, tile) base bounds over the policy's own
    grid.

    ``values`` maps unit keys ``(wi, ti, tj)`` to base bounds in
    ``cfg.eb`` units (``cfg.mode`` applies, as on the scalar path);
    units absent from ``values`` use ``default``."""

    window_t: int
    tile_h: int
    tile_w: int
    default: float
    values: tuple = ()          # sorted (((wi, ti, tj), eb), ...)

    @classmethod
    def make(cls, window_t: int, tile_h: int, tile_w: int,
             default: float, values=None) -> "TilePolicy":
        """Normalized construction from a ``{key: eb}`` mapping."""
        items = tuple(sorted(
            (tuple(int(x) for x in k), float(ebv))
            for k, ebv in dict(values or {}).items()))
        pol = cls(window_t=int(window_t), tile_h=int(tile_h),
                  tile_w=int(tile_w), default=float(default),
                  values=items)
        pol.validate()
        return pol

    def validate(self):
        if min(self.window_t, self.tile_h, self.tile_w) < 1:
            raise ValueError(f"policy grid sizes must be >= 1: {self}")
        if not (self.default > 0.0):
            raise ValueError(f"policy default bound must be > 0, got "
                             f"{self.default}")
        for key, ebv in self.values:
            if len(key) != 3 or min(key) < 0:
                raise ValueError(f"policy unit key must be a "
                                 f"(wi, ti, tj) of non-negatives: {key}")
            if not (ebv > 0.0):
                raise ValueError(f"policy bound for {key} must be > 0, "
                                 f"got {ebv}")

    @property
    def is_uniform(self) -> bool:
        # an all-equal TilePolicy was opted into: it writes the
        # self-describing (version 3) container all the same
        return False

    def spec(self):
        """Canonical msgpack-able identity (plan knob and header form)."""
        return ("tile", int(self.window_t), int(self.tile_h),
                int(self.tile_w), float(self.default),
                tuple((tuple(int(x) for x in k), float(v))
                      for k, v in self.values))


def normalize(policy):
    """Config-level policy -> ``None`` for the uniform scalar path, a
    validated :class:`TilePolicy` otherwise.  Duck-typed so that the JAX
    package's policy objects are accepted too: one whose ``is_uniform``
    is True is uniform, one whose ``spec()`` is a ``"tile"`` spec is
    rebuilt from it."""
    if policy is None or policy == "uniform" \
            or getattr(policy, "is_uniform", False) is True:
        return None
    if isinstance(policy, TilePolicy):
        policy.validate()
        return policy
    if isinstance(policy, (tuple, list)):
        return policy_from_spec(policy)
    spec = getattr(policy, "spec", None)
    if callable(spec):
        s = spec()
        if isinstance(s, (tuple, list)) and s and s[0] == "tile":
            return policy_from_spec(s)
    raise TypeError(f"eb_policy must be None, 'uniform', UniformPolicy, "
                    f"TilePolicy or a policy spec, got {type(policy)}")


def policy_spec(policy):
    """Canonical spec of a normalized policy (None for uniform)."""
    return None if policy is None else policy.spec()


def policy_from_spec(spec) -> TilePolicy:
    """Inverse of :meth:`TilePolicy.spec` (accepts the list form a
    container header round-trips through)."""
    if not spec or spec[0] != "tile" or len(spec) != 6:
        raise ValueError(f"unknown eb policy spec: {spec!r}")
    _, wt, th, tw, default, values = spec
    return TilePolicy.make(wt, th, tw, default,
                           {tuple(k): v for k, v in values})


def min_bound(policy: TilePolicy) -> float:
    """The policy's tightest bound (``cfg.eb`` units)."""
    return float(min([policy.default] + [v for _, v in policy.values]))


def max_bound(policy: TilePolicy) -> float:
    """The policy's loosest bound (``cfg.eb`` units): what the global
    plan (tau, xi_unit) derives from."""
    return float(max([policy.default] + [v for _, v in policy.values]))


def levels_for(policy: TilePolicy, n_levels: int = 1) -> int:
    """Quantizer levels covering the policy's dynamic range,
    ``ceil(log2(loosest / tightest)) + 1``, never below ``n_levels``.
    Without them the tight units' vertices fall below xi_unit and are
    stored lossless instead of quantized at their own finer grid."""
    span = max_bound(policy) / min_bound(policy)
    return max(int(n_levels), int(math.ceil(math.log2(span))) + 1)


@functools.lru_cache(maxsize=32)
def _window_plane(policy: TilePolicy, wi: int, H: int, W: int):
    """(H, W) float64 plane of window ``wi``'s bounds (policy units):
    per-tile values min-reduced over ONE-CELL inflated owned boxes, so
    a vertex on (or next to) a tile seam takes the tighter side."""
    vals = dict(policy.values)
    th, tw = policy.tile_h, policy.tile_w
    plane = np.full((H, W), np.inf, np.float64)
    for ti in range(-(-H // th)):
        i0, i1 = ti * th, min(ti * th + th, H)
        for tj in range(-(-W // tw)):
            j0, j1 = tj * tw, min(tj * tw + tw, W)
            v = vals.get((wi, ti, tj), policy.default)
            sl = plane[max(i0 - 1, 0):min(i1 + 1, H),
                       max(j0 - 1, 0):min(j1 + 1, W)]
            np.minimum(sl, v, out=sl)
    plane.setflags(write=False)
    return plane


def frame_bounds(policy: TilePolicy, t: int, H: int, W: int,
                 factor: float) -> np.ndarray:
    """(H, W) float64 ABSOLUTE per-vertex base bounds for frame ``t``:
    the min over the windows owning frames t-1, t, t+1 (``(t + 1) //
    window_t`` counts even past the field's end), times the mode factor
    (1.0 for abs, the value range for rel)."""
    wis = sorted({tt // policy.window_t for tt in (t - 1, t, t + 1)
                  if tt >= 0})
    plane = _window_plane(policy, wis[0], H, W)
    for wi in wis[1:]:
        plane = np.minimum(plane, _window_plane(policy, wi, H, W))
    return plane * float(factor)


def frame_caps(policy: TilePolicy, t: int, H: int, W: int,
               factor: float, scale: float) -> np.ndarray:
    """(H, W) int64 fixed-point caps for frame ``t``: the per-vertex
    analogue of the plan's ``tau = floor(eb_abs * scale)``."""
    return np.floor(frame_bounds(policy, t, H, W, factor)
                    * float(scale)).astype(np.int64)


def field_bounds(policy: TilePolicy, shape, factor: float) -> np.ndarray:
    """(T, H, W) float64 absolute base bounds."""
    T, H, W = shape
    return np.stack([frame_bounds(policy, t, H, W, factor)
                     for t in range(T)])


def field_caps(policy: TilePolicy, shape, factor: float,
               scale: float) -> np.ndarray:
    """(T, H, W) int64 caps."""
    T, H, W = shape
    return np.stack([frame_caps(policy, t, H, W, factor, scale)
                     for t in range(T)])
