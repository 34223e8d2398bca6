"""Five-point explicit diffusion, plain PyTorch: the 5-point core's reference.

``u' = u + alpha * (u[y-1] + u[y+1] + u[x-1] + u[x+1] - 4 u)`` with
periodic edges; at alpha 0.2 this is the five-point average of
PolyBench/C 4.2 ``jacobi-2d``. ``u`` is ``(..., H, W)`` with any leading
batch axes.
"""

from __future__ import annotations

import torch


def step(u, *, alpha: float):
    nb = (torch.roll(u, 1, dims=-2) + torch.roll(u, -1, dims=-2)
          + torch.roll(u, 1, dims=-1) + torch.roll(u, -1, dims=-1))
    return u + alpha * (nb - 4.0 * u)


def run(u, steps: int, **kw):
    for _ in range(int(steps)):
        u = step(u, **kw)
    return u
