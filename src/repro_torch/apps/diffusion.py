"""2-D diffusion (Jacobi) — the second SPD application, on the port.

The port of the JAX package's ``apps/diffusion.py``: the five-point Jacobi
core

    u'[y, x] = u + alpha * (u[y-1] + u[y+1] + u[x-1] + u[x+1] - 4u)

as SPD text (one main-stream word, four ``Stencil2D`` reads, diffusivity
``alpha`` as an ``Append_Reg``), a full-grid torch reference, the
sinusoidal initial condition with its exact discrete decay, and
:class:`DiffusionSimulation`, which runs the core through the generated
Hopper stream kernel (docs/pipeline.md §execute).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.compiler import CompiledCore, Registry, f32
from repro_torch.core.legalize import blocking_plan
from repro_torch.core.spd import parse_spd
from repro_torch.interop import resolve_device

#: Stencil taps of the five-point Laplacian: (dy, dx, port) per neighbor.
NEIGHBORS = ((1, 0, "un"), (-1, 0, "us"), (0, 1, "uw"), (0, -1, "ue"))


def diffusion_spd(width: int, mode: str = "wrap",
                  name: str = "Diff2D") -> str:
    """SPD source of one explicit diffusion (Jacobi) time step."""
    L = [
        f"Name {name};",
        "Main_In {mi::u};",
        "Main_Out {mo::u2};",
        "Append_Reg {rg::alpha};",
    ]
    for dy, dx, port in NEIGHBORS:
        L.append(
            f"HDL T{port}, 0, ({port}) = Stencil2D(u), "
            f"dy={dy}, dx={dx}, W={width}, mode={mode};"
        )
    L.append("EQU Nlap, lap = un + us + ue + uw - 4.0*u;")
    L.append("EQU Nnew, u2 = u + alpha*lap;")
    return "\n".join(L)


def compile_diffusion(width: int, mode: str = "wrap") -> CompiledCore:
    """Parse + compile the diffusion core into a fresh registry."""
    return Registry().compile(parse_spd(diffusion_spd(width, mode)))


# --------------------------------------------------------------------------
# Full-grid torch reference (the oracle)
# --------------------------------------------------------------------------


def diffusion_ref_step(u, alpha):
    """One explicit five-point diffusion step, periodic boundaries."""
    lap = (
        torch.roll(u, 1, dims=0) + torch.roll(u, -1, dims=0)
        + torch.roll(u, 1, dims=1) + torch.roll(u, -1, dims=1)
        - 4.0 * u
    )
    return u + f32(alpha, u.device) * lap


def diffusion_ref_run(u, alpha, steps: int):
    for _ in range(steps):
        u = diffusion_ref_step(u, alpha)
    return u


# --------------------------------------------------------------------------
# Initial condition + analytic reference
# --------------------------------------------------------------------------


def sine_init(h: int, w: int, amp: float = 1.0, device="cuda"):
    """Lowest sinusoidal mode; returns ``(u0, decay_per_step(alpha))``.

    For u0 = amp·sin(ky·y)·sin(kx·x) the explicit five-point scheme
    decays the mode *exactly* by
    ``g(alpha) = 1 - alpha·(4 - 2cos(kx) - 2cos(ky))`` per step.
    """
    dev = resolve_device(device)
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    ky, kx = 2 * math.pi / h, 2 * math.pi / w
    u0 = amp * torch.sin(ky * y) * torch.sin(kx * x)

    def decay_per_step(alpha: float) -> float:
        return 1.0 - alpha * (4.0 - 2.0 * math.cos(kx) - 2.0 * math.cos(ky))

    return u0, decay_per_step


class DiffusionSimulation:
    """Compiled-core driver: the SPD core, its problem size, and the
    generated stream kernel it runs on (``device="cpu"`` runs the plain
    versions; ``"cuda"`` without a card raises)."""

    def __init__(self, height: int, width: int, alpha: float = 0.2,
                 device="cuda"):
        if not 0.0 < alpha <= 0.25:
            raise ValueError(f"explicit scheme needs 0 < alpha <= 0.25, "
                             f"got {alpha}")
        self.height, self.width, self.alpha = height, width, alpha
        self.core = compile_diffusion(width)
        self.kernel = self.core.stream_kernel(device=device)
        self.device = self.kernel.device

    @property
    def hardware_report(self):
        return self.core.hardware_report

    def explorer(self, **kw):
        """Design-space :class:`~repro_torch.core.explorer.Explorer` of the
        core at this problem size; GPU lattice points execute through its
        generated kernel (docs/pipeline.md §execute)."""
        kw.setdefault("core", self.kernel)
        return self.core.explorer(
            elems=self.height * self.width, grid_w=self.width, **kw
        )

    def state(self, u) -> torch.Tensor:
        return self.kernel.pack([u])

    def run(self, u, steps: int, *, m: int = 1, block_h: int | None = None,
            d: int = 1):
        """Advance ``steps`` diffusion steps through the stream kernel.

        ``d > 1`` shards the grid's rows over that many devices with halo
        exchange (docs/port.md §distribute): ``cuda:0 … cuda:d-1``, or the
        CPU d times on the CPU; needs ``d | height``.
        """
        if block_h is None:
            block_h, m, _ = blocking_plan(self.height, 32, m,
                                          halo=self.kernel.halo, d=d)
        kern = self.kernel if d == 1 else self.kernel.sharded(d)
        out = kern.run_blocked(
            self.state(u), (self.alpha,), steps=steps, m=m,
            block_h=block_h,
        )
        return out[0]
