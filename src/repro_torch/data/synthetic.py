"""Synthetic time-varying 2D vector fields with moving critical points.

Stand-ins for the paper's four datasets (SCF / CFVKV / HCBA / FS), all
analytic or procedurally generated so benchmarks are reproducible without
external downloads:

  vortex_street   -- advecting alternating Oseen vortices behind a
                     cylinder + uniform base flow (von Karman analogue)
  double_gyre     -- the classic time-periodic double gyre (moving saddle)
  heated_plume    -- oscillating buoyant plume from a streamfunction
                     (Boussinesq analogue; divergence-free)
  turbulence      -- band-limited random streamfunction with phase
                     advection (decaying-turbulence ensemble analogue)

All return (u, v) float32 arrays of shape (T, H, W).
"""
from __future__ import annotations

import numpy as np


def _grid(H, W, Lx=2.0, Ly=1.0):
    y = np.linspace(0.0, Ly, H, dtype=np.float64)
    x = np.linspace(0.0, Lx, W, dtype=np.float64)
    X, Y = np.meshgrid(x, y)  # (H, W)
    return X, Y


def vortex_street(T=64, H=64, W=128, n_vortices=6, u0=0.35, seed=0):
    X, Y = _grid(H, W)
    u = np.zeros((T, H, W), dtype=np.float64)
    v = np.zeros((T, H, W), dtype=np.float64)
    rc = 0.08
    for t in range(T):
        tt = t * 0.05
        uu = np.full_like(X, u0)
        vv = np.zeros_like(Y)
        for k in range(n_vortices):
            sgn = 1.0 if k % 2 == 0 else -1.0
            cx = (0.3 + 0.35 * k + u0 * tt) % 2.2 - 0.1
            cy = 0.5 + sgn * 0.12
            dx = X - cx
            dy = Y - cy
            r2 = dx * dx + dy * dy + 1e-12
            gamma = sgn * 0.25 * (1.0 - np.exp(-r2 / rc**2)) / r2
            uu += -gamma * dy
            vv += gamma * dx
        u[t] = uu
        v[t] = vv
    return u.astype(np.float32), v.astype(np.float32)


def double_gyre(T=64, H=64, W=128, A=0.1, eps=0.25, omega=2.0 * np.pi / 10.0):
    X, Y = _grid(H, W, Lx=2.0, Ly=1.0)
    u = np.zeros((T, H, W), dtype=np.float64)
    v = np.zeros((T, H, W), dtype=np.float64)
    for t in range(T):
        tt = t * 0.1
        a = eps * np.sin(omega * tt)
        b = 1.0 - 2.0 * a
        f = a * X**2 + b * X
        dfdx = 2.0 * a * X + b
        u[t] = -np.pi * A * np.sin(np.pi * f) * np.cos(np.pi * Y)
        v[t] = np.pi * A * np.cos(np.pi * f) * np.sin(np.pi * Y) * dfdx
    return u.astype(np.float32), v.astype(np.float32)


def heated_plume(T=64, H=96, W=48, seed=1):
    X, Y = _grid(H, W, Lx=1.0, Ly=2.0)
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * np.pi, size=4)
    u = np.zeros((T, H, W), dtype=np.float64)
    v = np.zeros((T, H, W), dtype=np.float64)
    for t in range(T):
        tt = t * 0.08
        # oscillating plume streamfunction: rising core + side rolls
        psi = (
            0.15 * np.sin(np.pi * X) * np.sin(0.5 * np.pi * Y + 0.3 * tt)
            + 0.05
            * np.sin(2 * np.pi * X + 0.8 * np.sin(tt + phases[0]))
            * np.sin(np.pi * Y + phases[1])
            + 0.03 * np.cos(3 * np.pi * X + tt) * np.sin(1.5 * np.pi * Y)
        )
        u[t] = np.gradient(psi, axis=0)   # d(psi)/dy
        v[t] = -np.gradient(psi, axis=1)  # -d(psi)/dx
    return u.astype(np.float32), v.astype(np.float32)


def turbulence(T=64, H=64, W=64, n_modes=12, seed=2):
    rng = np.random.default_rng(seed)
    X, Y = _grid(H, W, Lx=1.0, Ly=1.0)
    kx = rng.integers(1, 5, n_modes)
    ky = rng.integers(1, 5, n_modes)
    amp = rng.normal(0, 1.0, n_modes) / np.sqrt(kx**2 + ky**2)
    ph = rng.uniform(0, 2 * np.pi, n_modes)
    drift = rng.normal(0, 0.4, (n_modes, 2))
    u = np.zeros((T, H, W), dtype=np.float64)
    v = np.zeros((T, H, W), dtype=np.float64)
    for t in range(T):
        tt = t * 0.06
        psi = np.zeros_like(X)
        for m in range(n_modes):
            psi += amp[m] * np.sin(
                2 * np.pi * (kx[m] * (X - drift[m, 0] * tt))
                + ph[m]
            ) * np.sin(2 * np.pi * ky[m] * (Y - drift[m, 1] * tt))
        u[t] = np.gradient(psi, axis=0)
        v[t] = -np.gradient(psi, axis=1)
    return u.astype(np.float32), v.astype(np.float32)


def advected_turbulence(T=64, H=64, W=64, u0=3.0, amp=1.5, seed=4,
                        n_modes=24):
    """Taylor-hypothesis flow: small-scale frozen turbulence advected by
    a uniform carrier at ``u0`` grid cells per frame -- the
    advection-dominated regime where the paper's semi-Lagrangian
    predictor wins (Sec. VI).  Velocities are in grid-units/frame, so
    CFL metadata is dt=dx=dy=1."""
    rng = np.random.default_rng(seed)
    # periodic rough streamfunction on an extended domain
    Wp = W + int(np.ceil(u0 * T)) + 2
    x = np.arange(Wp)[None, :]
    y = np.arange(H)[:, None]
    psi = np.zeros((H, Wp))
    for _ in range(n_modes):
        kx = rng.integers(2, 12)
        ky = rng.integers(2, 12)
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        a = rng.normal(0, 1.0) / np.hypot(kx, ky)
        psi += a * np.sin(2 * np.pi * kx * x / W + ph1) * np.sin(
            2 * np.pi * ky * y / H + ph2)
    uu = np.gradient(psi, axis=0)
    vv = -np.gradient(psi, axis=1)
    # normalize fluctuations to amp * u0 peak so critical points exist
    # (u = u0 + u' crosses zero where |u'| > u0) and their trajectories
    # advect with the frame -- the paper's hurricane-track scenario
    peak = max(np.abs(uu).max(), np.abs(vv).max(), 1e-9)
    uu *= amp * u0 / peak
    vv *= amp * u0 / peak
    u = np.zeros((T, H, W))
    v = np.zeros((T, H, W))
    for t in range(T):
        # pattern frozen in the co-moving frame; the sampling window
        # slides backward so features advect in +j at u0 px/frame
        # (u[t][j] == u[t-1][j - u0], the SL-predictable direction)
        s = u0 * (T - 1 - t)
        i0 = int(np.floor(s))
        a = s - i0
        u[t] = u0 + (1 - a) * uu[:, i0 : i0 + W] + a * uu[:, i0 + 1 : i0 + 1 + W]
        v[t] = (1 - a) * vv[:, i0 : i0 + W] + a * vv[:, i0 + 1 : i0 + 1 + W]
    return u.astype(np.float32), v.astype(np.float32)


DATASETS = {
    "vortex_street": vortex_street,
    "double_gyre": double_gyre,
    "heated_plume": heated_plume,
    "turbulence": turbulence,
    "advected_turbulence": advected_turbulence,
}


def load(name: str, **kw):
    return DATASETS[name](**kw)
