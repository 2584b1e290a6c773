"""The port's three SL steppers against the JAX package's (CPU).

``core/predictors.py`` carries one stepper for each ``sl_backend`` tag
the JAX package writes: "numpy" (f64, every operation rounded once),
"xla" (f64 with the multiply-adds XLA:CPU contracts) and "pallas" (f32,
the Pallas kernel's body in interpret mode).  Held here, bitwise:

* each variant's integers against the reference's
  ``backend.sl_stepper(tag, ...)`` on integer planes, with H % 8 == 0
  and != 0 (where "pallas" runs the f64 "xla" path), n_max 8 and 32 and
  displacements up to about 250 cells, so that the substeps clamp, and
  on planes where d_inf / d_max lands on an integer (XLA multiplies by
  the reciprocal there);
* the f32 samples against ``sl_predict_pallas`` (n_max 8) and
  ``sl_predict_batched_pallas`` (n_max 8 and 32) in interpret mode, at
  displacements up to about 250 cells: both kernels run the one tile
  body ``_sl_tile``, so n_max 32 is held through one batched call;
* both FMA emulations against an exact ``fractions.Fraction`` oracle on
  random inputs and on constructed ties, where a product rounded before
  the sum gives another float.

Each reference stepper is jitted once per (backend, CFL, d_max, n_max)
and plane shape; a Pallas body at n_max 32 takes about 20 s to compile,
so only the batched float check uses one (the f32 stepper's integers are
held at n_max 8; at n_max 32 the "pallas" tag is held where it runs the
"xla" path).
"""
import pytest

pytest.importorskip("torch")

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import backend as r_backend
from repro.kernels.semilagrange import kernel as r_kernel
from repro_torch.core import backend, predictors as P
from repro_torch.kernels.semilagrange import ops, ref

CFL = (0.9, 1.1)
G2F = 0.01


def _planes(shape, amp, seed):
    """Integer planes whose velocities x * G2F are about ``amp`` cells
    a step (normal, so a few pixels reach 2.5 amp)."""
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * amp / G2F).astype(np.int64)
                 for _ in range(2))


def _reference(tag, xu, xv, d_max, n_max, g2f=G2F, cfl=CFL):
    step = r_backend.sl_stepper(tag, cfl[0], cfl[1], d_max, n_max)
    return tuple(np.asarray(a) for a in step(jnp.asarray(xu), jnp.asarray(xv),
                                              g2f))


def _port(variant, xu, xv, d_max, n_max, g2f=G2F, cfl=CFL):
    return tuple(a.numpy() for a in P.sl_predict_frame(
        torch.as_tensor(xu), torch.as_tensor(xv), g2f, cfl[0], cfl[1],
        d_max, n_max, variant))


def _n_diff(a, b):
    return int(sum((x != y).sum() for x, y in zip(a, b)))


# (tag, plane shape, velocity amplitude in cells, n_max): RK2 only, a mix
# of RK2 and substeps, substeps clamped at n_max; H = 12 is no multiple of
# the Pallas kernel's 8-row tile
STEPPER_CASES = [
    (tag, (16, 24), amp, 8) for tag in ("numpy", "xla", "pallas")
    for amp in (0.5, 12, 100)
] + [
    ("xla", (12, 20), 100, 32),
    ("pallas", (12, 20), 100, 32),
    ("pallas", (12, 20), 100, 8),
    ("pallas", (12, 20), 12, 8),
]


@pytest.mark.parametrize("tag,shape,amp,n_max", STEPPER_CASES)
def test_stepper_equals_reference(tag, shape, amp, n_max):
    xu, xv = _planes(shape, amp, seed=int(amp * 10) + n_max + shape[0])
    want = _reference(tag, xu, xv, 2.0, n_max)
    variant = backend.sl_variant(tag, shape[0])
    assert variant == ("xla" if tag == "pallas" and shape[0] % 8 else tag)
    got = _port(variant, xu, xv, 2.0, n_max)
    assert _n_diff(got, want) == 0
    # the stack of frames (K4's plain version) gives each frame's integers
    stack = ref.sl_step_batched(torch.as_tensor(np.stack([xu, xv[::-1]])),
                                torch.as_tensor(np.stack([xv, xu[::-1]])),
                                G2F, *CFL, 2.0, n_max, variant)
    assert np.array_equal(stack[0][0].numpy(), got[0])
    assert np.array_equal(stack[1][0].numpy(), got[1])
    if amp >= 12 and variant == "pallas":
        # non-vacuous: the f64 steppers give other integers
        for other in ("numpy", "xla"):
            assert _n_diff(_port(other, xu, xv, 2.0, n_max), want) > 0, \
                other


@pytest.mark.parametrize("tag,d_max,k,n_max",
                         [("pallas", 0.3, 7, 8), ("xla", 0.7, 15, 32)])
def test_stepper_multiplies_by_the_reciprocal_of_d_max(tag, d_max, k, n_max):
    """XLA turns d_inf / d_max (a constant) into d_inf * (1 / d_max).
    With g2 = d_max and cx = 1 a pixel with x = k has d_inf = k * d_max
    rounded, whose quotient by d_max is k but whose product with the
    reciprocal rounds above it: one substep more."""
    shape = (16, 24)
    rng = np.random.default_rng(k)
    xu = (rng.standard_normal(shape) * 12).astype(np.int64)
    xv = (rng.standard_normal(shape) * 12).astype(np.int64)
    hit = rng.random(shape) < 0.5
    xu[hit] = k * np.where(xu[hit] < 0, -1, 1)
    xv[hit] = 0
    dt = torch.float32 if tag == "pallas" else torch.float64
    dm = torch.tensor(d_max, dtype=dt)
    d_inf = (torch.as_tensor(xu).to(dt) * dm).abs()
    assert bool((torch.ceil(d_inf / dm) != torch.ceil(d_inf * (1.0 / dm)))
                .any())
    cfl = (1.0, d_max)
    want = _reference(tag, xu, xv, d_max, n_max, g2f=d_max, cfl=cfl)
    got = _port(tag, xu, xv, d_max, n_max, g2f=d_max, cfl=cfl)
    assert _n_diff(got, want) == 0


# (plane shape, velocity amplitude in cells, n_max) of the float checks;
# H = 12 is no multiple of the kernel's 8-row tile: the kernel writes its
# first 8 rows only (its grid is H // 8 row tiles)
FLOAT_CASES = [((16, 24), 150, 8), ((16, 24), 250, 8), ((12, 20), 60, 8)]


@pytest.mark.parametrize("shape,amp,n_max", FLOAT_CASES)
def test_f32_samples_equal_pallas_kernel(shape, amp, n_max):
    rng = np.random.default_rng(n_max + shape[0] + amp)
    u, v = ((rng.standard_normal(shape) * amp).astype(np.float32)
            for _ in range(2))
    ku, kv = r_kernel.sl_predict_pallas(jnp.asarray(u), jnp.asarray(v),
                                        *CFL, 2.0, n_max, interpret=True)
    su, sv = P.sl_sample(torch.as_tensor(u), torch.as_tensor(v), *CFL, 2.0,
                         n_max, "pallas")
    rows = shape[0] // r_kernel.TILE_H * r_kernel.TILE_H
    for k, s in ((ku, su), (kv, sv)):
        assert s.dtype == torch.float32
        assert np.array_equal(np.asarray(k)[:rows].view(np.uint32),
                              s.numpy()[:rows].view(np.uint32))
    # non-vacuous: the same positions in f64 give other floats
    du, _ = P.sl_sample(torch.as_tensor(u).double(),
                        torch.as_tensor(v).double(), *CFL, 2.0, n_max,
                        "xla")
    assert not np.array_equal(du.float().numpy(), su.numpy())


@pytest.mark.parametrize("n_max", [8, 32])
def test_f32_samples_equal_batched_pallas_kernel(n_max):
    rng = np.random.default_rng(n_max)
    shape = (3, 16, 24)
    u, v = ((rng.standard_normal(shape) * 100).astype(np.float32)
            for _ in range(2))
    ku, kv = r_kernel.sl_predict_batched_pallas(
        jnp.asarray(u), jnp.asarray(v), *CFL, 2.0, n_max, interpret=True)
    su, sv = P.sl_sample(torch.as_tensor(u), torch.as_tensor(v), *CFL, 2.0,
                         n_max, "pallas")
    for k, s in ((ku, su), (kv, sv)):
        assert np.array_equal(np.asarray(k).view(np.uint32),
                              s.numpy().view(np.uint32))


# ----------------------------------------------------------------------
# the FMA emulations against exact arithmetic
# ----------------------------------------------------------------------

def _nearest(exact: Fraction, ftype):
    """The float of ``ftype`` nearest to ``exact``, ties to even."""
    if ftype is np.float64:
        return np.float64(float(exact))     # int / int: correctly rounded
    c = np.float32(float(exact))
    best = None
    for x in (np.nextafter(c, np.float32(-np.inf)), c,
              np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(x)) - exact)
        key = (d, int(np.asarray(x).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, x)
    return best[1]


def _random_operands(ftype, n, seed):
    rng = np.random.default_rng(seed)

    def one():
        return (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)) \
            .astype(ftype)

    a, b = one(), one()
    # c near -a*b too, where the sum cancels
    c = np.where(rng.random(n) < 0.3, -(a.astype(np.float64) * b)
                 .astype(ftype) * ftype(1 + 2.0 ** -10), one())
    return a, b, c.astype(ftype)


def _tie_operands(ftype):
    """a * b + c just below, at and just above half an ulp of c, where
    rounding a * b first (or the sum twice) gives the other neighbour."""
    p = 24 if ftype is np.float32 else 53
    s = 2.0 ** -(p // 2 + 6)
    a, b, c = [], [], []
    for e in (-3, 0, 5):
        for sign in (1.0, -1.0):
            for k in (1, 2, 2 ** (p - 2) + 1):       # odd and even c
                cc = (1.0 + k * 2.0 ** (1 - p)) * 2.0 ** e
                half = 2.0 ** (e - p)                # half an ulp of cc
                for aa, bb in ((half * (1 + s), 1 - s),   # just below
                               (half, 1.0),               # the tie
                               (half * (1 + s), 1 + s)):  # just above
                    a.append(sign * aa)
                    b.append(bb)
                    c.append(sign * cc)
    return tuple(np.asarray(x, dtype=ftype) for x in (a, b, c))


@pytest.mark.parametrize("ftype", [np.float32, np.float64],
                         ids=["fma32", "fma64"])
def test_fma_emulation_equals_exact_rounding(ftype):
    fma = P.fma32 if ftype is np.float32 else P.fma64
    ra, rb, rc = _random_operands(ftype, 3000, seed=24 if ftype is np.float32
                                  else 53)
    ta, tb, tc = _tie_operands(ftype)
    a, b, c = (np.concatenate(x) for x in ((ra, ta), (rb, tb), (rc, tc)))
    got = fma(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    assert got.dtype == ftype
    want = np.asarray([_nearest(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)), ftype)
                       for x, y, z in zip(a, b, c)], dtype=ftype)
    assert np.array_equal(got, want)
    # the ties are non-vacuous: the product rounded before the sum
    # gives another float on some of them
    n = len(ta)
    naive = (ta * tb + tc).astype(ftype)
    assert (naive != want[-n:]).any()


def test_dispatch_runs_each_variant_on_the_cpu():
    """The ops dispatchers take a CPU tensor to the variant's plain
    version, and the header tag maps to the variant per plane height."""
    xu, xv = _planes((16, 24), 12, seed=5)
    args = (torch.as_tensor(xu)[None], torch.as_tensor(xv)[None], G2F,
            *CFL, 2.0, 8)
    for v in P.SL_VARIANTS:
        got = ops.sl_step_batched(*args, v)
        want = P.sl_predict_frame(*args, v)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert backend.sl_variant("pallas", 24) == "pallas"
    assert backend.sl_variant("pallas", 100) == "xla"
    assert backend.sl_variant("xla", 24) == "xla"
    with pytest.raises(ValueError, match="stepper"):
        backend.sl_variant("tpu", 24)
    with pytest.raises(ValueError, match="stepper"):
        P.sl_predict_frame(*args, "f32")
