"""D2Q9 BGK lattice Boltzmann, plain PyTorch: the uLBM PE's reference.

One time step of the paper's processing element (Sano et al. 2015, §III-B):
BGK collision on fluid cells (``attr < 0.5``; walls pass their populations
through), translation of each population along its lattice vector with
periodic edges, then full-way bounce-back on solid cells (``attr >= 0.5``)
with the moving-wall momentum correction ``6 w_i rho0 (e_i . u_lid)`` on
the lid (``attr >= 1.5``).

Populations are ``(..., 9, H, W)`` with any leading batch axes; ``attr``
is ``(..., H, W)``. Axis -2 is y, axis -1 is x, and population i moves by
``(EY[i], EX[i])``. ``dtype`` runs the same arithmetic in another float
type (the lower-precision control of the benchmark's comparison).
"""

from __future__ import annotations

import torch

EX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
EY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4


def _col(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype,
                        device=like.device).reshape(9, 1, 1)


def equilibrium(rho, ux, uy):
    """Second-order equilibrium populations ``(..., 9, H, W)`` of the
    density and velocity fields ``(..., H, W)``."""
    rho, ux, uy = (t.unsqueeze(-3) for t in (rho, ux, uy))
    cu = _col(EX, rho) * ux + _col(EY, rho) * uy
    usq = ux * ux + uy * uy
    return _col(W, rho) * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)


def collide(f, tau: float):
    """BGK relaxation towards the local equilibrium."""
    rho = f.sum(dim=-3)
    px = (f[..., 1, :, :] + f[..., 5, :, :] + f[..., 8, :, :]
          - f[..., 3, :, :] - f[..., 6, :, :] - f[..., 7, :, :])
    py = (f[..., 2, :, :] + f[..., 5, :, :] + f[..., 6, :, :]
          - f[..., 4, :, :] - f[..., 7, :, :] - f[..., 8, :, :])
    feq = equilibrium(rho, px / rho, py / rho)
    return f - (1.0 / tau) * (f - feq)


def stream(f):
    """Each population moves one cell along its lattice vector, periodic."""
    return torch.stack([
        torch.roll(f[..., i, :, :], shifts=(EY[i], EX[i]), dims=(-2, -1))
        for i in range(9)
    ], dim=-3)


def bounce_back(f, attr, u_lid: float, rho0: float):
    """Reflect every population on solid cells; the lid adds momentum."""
    solid = (attr >= 0.5).unsqueeze(-3)
    lid = (attr >= 1.5).unsqueeze(-3)
    refl = f[..., list(OPP), :, :]
    corr = _col([6.0 * w * ex * rho0 * u_lid for w, ex in zip(W, EX)], f)
    return torch.where(solid, torch.where(lid, refl + corr, refl), f)


def step(f, attr, *, tau: float, u_lid: float = 0.0, rho0: float = 1.0):
    """One time step: collide (fluid cells) -> stream -> boundary."""
    fluid = (attr < 0.5).unsqueeze(-3)
    f = torch.where(fluid, collide(f, tau), f)
    return bounce_back(stream(f), attr, u_lid, rho0)


def run(f, attr, steps: int, **kw):
    for _ in range(int(steps)):
        f = step(f, attr, **kw)
    return f
