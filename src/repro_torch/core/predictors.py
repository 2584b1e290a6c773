"""Predictors on the dual-quantized integer field X (quantize.py).

Block-local 3D Lorenzo: res_0 = D2(X_0), res_t = D2(X_t) - D2(X_{t-1}),
with D2 the tile-local (``block`` x ``block``) 2D first-order difference;
decode is X_t = X_{t-1} + C2(res_t) with C2 the tile-local inclusive 2D
cumsum.  Exact int64 inverses.

Semi-Lagrangian (SL): backtrace every pixel along the previous frame's
velocity -- RK2 midpoint when the CFL displacement d_inf <= d_max,
otherwise ceil(d_inf / d_max) (at most n_max) clamped Euler substeps --
and bilinear-sample frame t-1 at the departure point.
``sl_predict_frame`` is the plain version of the JAX package's three
steppers (``SL_VARIANTS``), one frame or a stack of frames: "numpy", a
literal transcription of its numpy stepper
(``backend._sl_predict_frame_np``), op for op; "xla" and "pallas", the
same op order with XLA:CPU's fused multiply-adds, in f64 and f32.  Each
torch op rounds once and the FMAs are exact emulations (``fma32``,
``fma64``), so each variant is bitwise equal to the reference's stepper
on the CPU; the CUDA kernels round the same way (``-fmad=false`` and
``__fma_rn`` / ``__fmaf_rn`` at the contracted sites).
"""
from __future__ import annotations

import torch

DEFAULT_BLOCK = 16


# ----------------------------------------------------------------------
# block-local Lorenzo
# ----------------------------------------------------------------------

def _shift1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x[..., i-1, ...] along ``dim`` with zero at i == 0."""
    out = torch.zeros_like(x)
    n = x.shape[dim]
    out.narrow(dim, 1, n - 1).copy_(x.narrow(dim, 0, n - 1))
    return out


def _edge_mask(n: int, block: int, like: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(n, device=like.device)
    return ((idx % block) != 0).to(like.dtype)


def d2_block(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Tile-local 2D first-order difference over the last two dims."""
    mi = _edge_mask(x.shape[-2], block, x)[:, None]
    mj = _edge_mask(x.shape[-1], block, x)[None, :]
    xi = _shift1(x, x.ndim - 2) * mi
    xj = _shift1(x, x.ndim - 1) * mj
    xij = _shift1(_shift1(x, x.ndim - 2), x.ndim - 1) * (mi * mj)
    return x - xi - xj + xij


def _block_cumsum(a: torch.Tensor, dim: int, block: int) -> torch.Tensor:
    n = a.shape[dim]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        shape = list(a.shape)
        shape[dim] = pad
        a = torch.cat([a, a.new_zeros(shape)], dim=dim)
    shape = list(a.shape)
    shape[dim:dim + 1] = [nb, block]
    out = torch.cumsum(a.reshape(shape), dim=dim + 1)
    shape2 = list(a.shape)
    return out.reshape(shape2).narrow(dim, 0, n)


def c2_block(r: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Tile-local 2D inclusive cumsum (inverse of d2_block)."""
    return _block_cumsum(_block_cumsum(r, r.ndim - 2, block), r.ndim - 1,
                         block)


def lorenzo_encode(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """res (T, H, W) int64 from X (T, H, W) int64."""
    d2 = d2_block(x, block)
    return d2 - _shift1(d2, 0)


# ----------------------------------------------------------------------
# semi-Lagrangian: the JAX package's three steppers
# ----------------------------------------------------------------------

# One variant for each ``sl_backend`` tag the JAX package writes (its
# core/backend.py::sl_stepper):
#   "numpy"   f64, every operation rounded once, in the op order of its
#             numpy stepper (backend._sl_predict_frame_np)
#   "xla"     f64 in the same op order, with the multiply-adds that
#             XLA:CPU contracts into fused multiply-adds
#             (predictors.sl_predict_frame under jit)
#   "pallas"  f32 with the same contractions: the Pallas kernel's body
#             (kernels/semilagrange/kernel.py::_sl_tile) as XLA:CPU
#             compiles it in interpret mode
# The contracted sites: the RK2 midpoint ii - v (0.5 cy) and departure
# point ii - v_h cy, one FMA each, and the bilinear sum
# fma(w11, f11, fma(w10, f10, fma(w00, f00, w01 f01))).  The substep
# pi - (vs cy) / n_sub keeps its two roundings: a division stands
# between the product and the difference.  XLA also turns d_inf / d_max
# (a constant) into d_inf * (1 / d_max).
SL_VARIANTS = ("numpy", "xla", "pallas")


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e): s = a + b rounded, e its exact error (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """s + e rounded to odd, from s = RN(s + e) and the exact error e: s
    where exact or where s's last bit is odd, else s's neighbour toward
    e (the other end of the interval holding s + e)."""
    bits = s.view(torch.int64 if s.dtype == torch.float64 else torch.int32)
    nudge = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a * b + c for float32 tensors, rounded once to float32: the f64
    product of two floats is exact (24 + 24 bits), its sum with c is
    rounded to odd in f64 and then to nearest in f32, which is the
    correctly rounded result because 53 >= 24 + 2."""
    p = a.to(torch.float64) * b.to(torch.float64)
    return _round_odd(*_two_sum(p, c.to(torch.float64))).to(torch.float32)


_SPLITTER = 134217729.0            # 2^27 + 1: Veltkamp's split of an f64


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e): p = a * b rounded, e its exact error (Dekker)."""
    p = a * b

    def split(x):
        c = x * _SPLITTER
        hi = c - (c - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a * b + c for float64 tensors, rounded once: Boldo and
    Melquiond's emulation through rounding to odd ("Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd",
    IEEE TC 2008): (uh, ul) = a * b exactly, (th, tl) = c + uh exactly,
    then th + RO(tl + ul) rounded to nearest.  Exact unless a product
    or sum overflows or a product falls below 2^-969; a non-finite
    product or sum takes the plain a * b + c."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    z = th + _round_odd(*_two_sum(tl, ul))
    return torch.where(torch.isfinite(z), z, a * b + c)


def _to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> float32 rounded to nearest even (XLA's convert, CUDA's
    __ll2float_rn) for |x| < 2^62: the f64 conversion is exact below
    2^53, and above it the remainder rounds it to odd first."""
    hi = x.to(torch.float64)
    lo = (x - hi.to(torch.int64)).to(torch.float64)
    return _round_odd(hi, lo).to(torch.float32)


def bilinear(f: torch.Tensor, fi: torch.Tensor, fj: torch.Tensor,
             fma=None):
    """Bilinear sample of f (..., H, W) at float positions of the same
    shape (each plane sampled on its own): (1-a)(1-b) f00 + (1-a) b f01
    + a (1-b) f10 + a b f11, left to right, each operation rounded once,
    or with ``fma`` (``fma32`` / ``fma64``) the contracted sum
    fma(w11, f11, fma(w10, f10, fma(w00, f00, w01 f01)))."""
    H, W = f.shape[-2:]
    i0 = torch.clamp(torch.floor(fi), 0, H - 1)
    j0 = torch.clamp(torch.floor(fj), 0, W - 1)
    a = fi - i0
    b = fj - j0
    i0 = i0.to(torch.int64)
    j0 = j0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=H - 1)
    j1 = torch.clamp(j0 + 1, max=W - 1)
    planes = f.reshape(-1, H * W)

    def at(i, j):
        return planes.gather(1, (i * W + j).reshape(planes.shape[0], -1)) \
            .reshape(f.shape)

    f00 = at(i0, j0)
    f01 = at(i0, j1)
    f10 = at(i1, j0)
    f11 = at(i1, j1)
    w00 = (1 - a) * (1 - b)
    w01 = (1 - a) * b
    w10 = a * (1 - b)
    w11 = a * b
    if fma is None:
        return w00 * f00 + w01 * f01 + w10 * f10 + w11 * f11
    return fma(w11, f11, fma(w10, f10, fma(w00, f00, w01 * f01)))


def sl_predict_frame(xu_prev: torch.Tensor, xv_prev: torch.Tensor,
                     g2f: float, cfl_x: float, cfl_y: float,
                     d_max: float, n_max: int, variant: str = "numpy"):
    """Predict frame t's base-grid integers from frame t-1's with the
    stepper ``variant`` (``SL_VARIANTS``): u = x * g2 in the variant's
    type, ``sl_sample``, then rint(sample / g2).

    xu_prev, xv_prev: (H, W) int64, or a (B, H, W) stack of independent
    frames.  Returns (pu, pv) int64 of the same shape.
    """
    if variant not in SL_VARIANTS:
        raise ValueError(f"unknown SL stepper {variant!r}; expected one "
                         f"of {SL_VARIANTS}")
    f32 = variant == "pallas"
    g2 = torch.tensor(float(g2f), dtype=torch.float32 if f32
                      else torch.float64, device=xu_prev.device)
    u = (_to_f32(xu_prev) if f32 else xu_prev.to(torch.float64)) * g2
    v = (_to_f32(xv_prev) if f32 else xv_prev.to(torch.float64)) * g2
    su, sv = sl_sample(u, v, cfl_x, cfl_y, d_max, n_max, variant)
    return (torch.round(su / g2).to(torch.int64),
            torch.round(sv / g2).to(torch.int64))


def sl_sample(u: torch.Tensor, v: torch.Tensor, cfl_x: float, cfl_y: float,
              d_max: float, n_max: int, variant: str):
    """Backtrace every pixel of the velocity planes (u, v) -- float32
    for "pallas", float64 otherwise; (H, W) or a (B, H, W) stack -- and
    sample them at its departure point: what the Pallas kernel
    ``sl_predict_pallas`` returns for "pallas".  The substep loop runs to
    the largest count of the stack; steps past a pixel's own count are
    masked identities, so each frame of a stack gets the values it gets
    alone."""
    fma = {"numpy": None, "xla": fma64, "pallas": fma32}[variant]
    dt = u.dtype
    dev = u.device

    def const(x):                  # a scalar rounded once to the type
        return torch.tensor(float(x), dtype=dt, device=dev)

    H, W = u.shape[-2:]
    cx = const(cfl_x)
    cy = const(cfl_y)
    dm = const(d_max)
    ii, jj = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev),
                            indexing="ij")
    ii = ii.expand(u.shape)
    jj = jj.expand(u.shape)
    d_inf = torch.maximum(torch.abs(u) * cx, torch.abs(v) * cy)

    if fma is None:
        i_h = ii - 0.5 * v * cy
        j_h = jj - 0.5 * u * cx
    else:
        i_h = fma(-v, 0.5 * cy, ii)
        j_h = fma(-u, 0.5 * cx, jj)
    i_h = torch.clamp(i_h, 0.0, H - 1.0)
    j_h = torch.clamp(j_h, 0.0, W - 1.0)
    u_h = bilinear(u, i_h, j_h, fma)
    v_h = bilinear(v, i_h, j_h, fma)
    if fma is None:
        i_rk = ii - v_h * cy
        j_rk = jj - u_h * cx
    else:
        i_rk = fma(-v_h, cy, ii)
        j_rk = fma(-u_h, cx, jj)

    # XLA rewrites the division by a constant as the product with its
    # reciprocal (rounded in the type)
    steps = d_inf / dm if fma is None else d_inf * (1.0 / dm)
    n_sub = torch.clamp(torch.ceil(steps), 1.0, float(n_max))
    n_hi = float(n_sub.max()) if n_sub.numel() else 0.0
    pi, pj = ii.clone(), jj.clone()
    s = 0
    while s < n_hi:
        us = bilinear(u, pi, pj, fma)
        vs = bilinear(v, pi, pj, fma)
        active = s < n_sub
        pi = torch.where(
            active, torch.clamp(pi - vs * cy / n_sub, 0.0, H - 1.0), pi)
        pj = torch.where(
            active, torch.clamp(pj - us * cx / n_sub, 0.0, W - 1.0), pj)
        s += 1

    use_rk = d_inf <= dm
    i_s = torch.clamp(torch.where(use_rk, i_rk, pi), 0.0, H - 1.0)
    j_s = torch.clamp(torch.where(use_rk, j_rk, pj), 0.0, W - 1.0)
    return bilinear(u, i_s, j_s, fma), bilinear(v, i_s, j_s, fma)
