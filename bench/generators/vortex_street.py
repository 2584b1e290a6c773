"""Seeded vortex-street field on the device: alternating Oseen vortices
advected behind a cylinder over a uniform base flow (a von Karman
analogue, the formula of the port's ``data/synthetic.vortex_street``).

The seed draws where in the shedding cycle (the vortices advance 2.2
domain units a cycle at ``u0 * 0.05`` a frame: 125.7 frames) the
simulation starts; frame ``t0 + k`` of one seed is the same frame
whichever chunk asks for it, so successive chunks continue one
simulation.
"""
from __future__ import annotations

import torch

N_VORTICES = 6
U0 = 0.35
RC = 0.08
DT = 0.05
PERIOD_FRAMES = 2.2 / (U0 * DT)


def params(seed: int, device) -> dict:
    """The seed's draws, made by a generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    r = torch.rand(1, generator=g, device=device, dtype=torch.float64)
    return {"t_start": float(r[0]) * PERIOD_FRAMES}


def make(T: int, H: int, W: int, t0: int, seed: int, device):
    """Frames [t0, t0 + T) of the seed's simulation: (u, v) float32
    tensors (T, H, W) on ``device``."""
    p = params(seed, device)
    f64 = torch.float64
    y = torch.linspace(0.0, 1.0, H, dtype=f64, device=device)
    x = torch.linspace(0.0, 2.0, W, dtype=f64, device=device)
    Y, X = torch.meshgrid(y, x, indexing="ij")
    tt = (torch.arange(T, dtype=f64, device=device) + t0
          + p["t_start"]) * DT
    u = torch.full((T, H, W), U0, dtype=f64, device=device)
    v = torch.zeros((T, H, W), dtype=f64, device=device)
    for k in range(N_VORTICES):
        sgn = 1.0 if k % 2 == 0 else -1.0
        cx = torch.remainder(0.3 + 0.35 * k + U0 * tt, 2.2) - 0.1
        cy = 0.5 + sgn * 0.12
        dx = X[None] - cx[:, None, None]
        dy = Y[None] - cy
        r2 = dx * dx + dy * dy + 1e-12
        gamma = sgn * 0.25 * (1.0 - torch.exp(-r2 / RC ** 2)) / r2
        u -= gamma * dy
        v += gamma * dx
    return u.to(torch.float32), v.to(torch.float32)

