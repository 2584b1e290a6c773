"""Seeded heated-plume field on the device: an oscillating buoyant plume
from a streamfunction with side rolls (a Boussinesq analogue, the formula
of the port's ``data/synthetic.heated_plume``; divergence-free).

The seed draws where in the plume's slowest cycle (2 pi / (0.3 * 0.08)
= 261.8 frames) the simulation starts; the side rolls keep the phases
the original draws for its default seed.  Frame ``t0 + k`` of one seed
is the same frame whichever chunk asks for it, so successive chunks
continue one simulation.
"""
from __future__ import annotations

import math

import torch

DT = 0.08
PERIOD_FRAMES = 2.0 * math.pi / (0.3 * DT)
# numpy.random.default_rng(1).uniform(0, 2 pi, 4): the original's
# default seed
PHASES = (3.2158701122134374, 5.971939531762716, 0.9057815605287021,
          5.960540267916768)


def params(seed: int, device) -> dict:
    """The seed's draws, made by a generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    r = torch.rand(1, generator=g, device=device, dtype=torch.float64)
    return {"phases": PHASES, "t_start": float(r[0]) * PERIOD_FRAMES}


def make(T: int, H: int, W: int, t0: int, seed: int, device):
    """Frames [t0, t0 + T) of the seed's simulation: (u, v) float32
    tensors (T, H, W) on ``device`` (x across W over [0, 1], y along H
    over [0, 2])."""
    p = params(seed, device)
    ph = p["phases"]
    f64 = torch.float64
    y = torch.linspace(0.0, 2.0, H, dtype=f64, device=device)
    x = torch.linspace(0.0, 1.0, W, dtype=f64, device=device)
    Y, X = torch.meshgrid(y, x, indexing="ij")
    X, Y = X[None], Y[None]
    tt = ((torch.arange(T, dtype=f64, device=device) + t0 + p["t_start"])
          * DT)[:, None, None]
    pi = math.pi
    psi = (0.15 * torch.sin(pi * X) * torch.sin(0.5 * pi * Y + 0.3 * tt)
           + 0.05 * torch.sin(2 * pi * X + 0.8 * torch.sin(tt + ph[0]))
           * torch.sin(pi * Y + ph[1])
           + 0.03 * torch.cos(3 * pi * X + tt) * torch.sin(1.5 * pi * Y))
    # np.gradient's unit spacing and first-order edges
    u = torch.gradient(psi, dim=1)[0]     # d(psi)/dy
    v = -torch.gradient(psi, dim=2)[0]    # -d(psi)/dx
    return u.to(torch.float32), v.to(torch.float32)
