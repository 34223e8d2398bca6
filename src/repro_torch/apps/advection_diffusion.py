"""Advection → reaction/diffusion — the 2-core stream-program app, on the port.

The port of the JAX package's ``apps/advection_diffusion.py``. The LBM
program (:func:`repro_torch.apps.lbm.lbm_program`) proves the program
layer on the paper's benchmark; this app is the second program workload
(docs/pipeline.md §program, docs/port.md §program): a 2-core chain whose
stages are *both* stencil cores, so fusing them composes halos (1 + 1 = 2
rows per step) instead of chaining pointwise work:

* ``Advect2D`` — first-order upwind advection with positive constant
  velocity ``(vx, vy)`` (``Append_Reg``), periodic boundaries:

      a = u - vx*(u - u[x-1]) - vy*(u - u[y-1])

* ``ReactDiffuse2D`` — explicit five-point diffusion plus a logistic
  reaction term (Fisher-KPP style), ``alpha``/``r`` as registers:

      u' = a + alpha*lap(a) + r*a*(1 - a)

``advdiff_spd`` is the hand-written monolithic single-core reference —
the same EQU formulae in one core, the stage-2 stencils applied to the
*computed* intermediate stream — which every fusion partition of the
program reproduces bit for bit (``tests/test_torch_advdiff.py``). A
full-grid torch oracle closes the loop.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.compiler import CompiledCore, Registry, f32
from repro_torch.core.spd import parse_spd
from repro_torch.interop import from_numpy, resolve_device

#: Five-point Laplacian taps (dy, dx, port): Stencil2D(u), dy=a, dx=b
#: reads u[y-a, x-b] (the translation convention of repro_torch.apps.lbm).
NEIGHBORS = ((1, 0, "n"), (-1, 0, "s"), (0, 1, "w"), (0, -1, "e"))


def advect_spd(width: int, mode: str = "wrap",
               name: str = "Advect2D") -> str:
    """Program stage 1: first-order upwind advection (halo 1)."""
    return "\n".join([
        f"Name {name};",
        "Main_In {mi::u};",
        "Main_Out {mo::a};",
        "Append_Reg {rg::vx,vy};",
        f"HDL Tux, 0, (uxm) = Stencil2D(u), dy=0, dx=1, "
        f"W={width}, mode={mode};",
        f"HDL Tuy, 0, (uym) = Stencil2D(u), dy=1, dx=0, "
        f"W={width}, mode={mode};",
        "EQU Nadv, a = u - vx*(u - uxm) - vy*(u - uym);",
    ])


def react_diffuse_spd(width: int, mode: str = "wrap",
                      name: str = "ReactDiffuse2D") -> str:
    """Program stage 2: five-point diffusion + logistic reaction (halo 1)."""
    L = [
        f"Name {name};",
        "Main_In {mi::a};",
        "Main_Out {mo::u2};",
        "Append_Reg {rg::alpha,r};",
    ]
    for dy, dx, port in NEIGHBORS:
        L.append(
            f"HDL T{port}, 0, (a{port}) = Stencil2D(a), "
            f"dy={dy}, dx={dx}, W={width}, mode={mode};"
        )
    L.append("EQU Nlap, lap = an + as + ae + aw - 4.0*a;")
    L.append("EQU Nnew, u2 = a + alpha*lap + r*a*(1.0 - a);")
    return "\n".join(L)


def advdiff_spd(width: int, mode: str = "wrap",
                name: str = "AdvDiff2D") -> str:
    """The monolithic single-core reference: both stages' formulae in one
    core, stage-2 stencils reading the computed intermediate ``a``
    (inferred halo 2 — the composed program halo)."""
    L = [
        f"Name {name};",
        "Main_In {mi::u};",
        "Main_Out {mo::u2};",
        "Append_Reg {rg::vx,vy,alpha,r};",
        f"HDL Tux, 0, (uxm) = Stencil2D(u), dy=0, dx=1, "
        f"W={width}, mode={mode};",
        f"HDL Tuy, 0, (uym) = Stencil2D(u), dy=1, dx=0, "
        f"W={width}, mode={mode};",
        "EQU Nadv, a = u - vx*(u - uxm) - vy*(u - uym);",
    ]
    for dy, dx, port in NEIGHBORS:
        L.append(
            f"HDL T{port}, 0, (a{port}) = Stencil2D(a), "
            f"dy={dy}, dx={dx}, W={width}, mode={mode};"
        )
    L.append("EQU Nlap, lap = an + as + ae + aw - 4.0*a;")
    L.append("EQU Nnew, u2 = a + alpha*lap + r*a*(1.0 - a);")
    return "\n".join(L)


def build_advdiff_registry(width: int, mode: str = "wrap") -> Registry:
    """Compile both stages + the monolithic reference into one registry."""
    reg = Registry()
    reg.compile(parse_spd(advect_spd(width, mode)))
    reg.compile(parse_spd(react_diffuse_spd(width, mode)))
    reg.compile(parse_spd(advdiff_spd(width, mode)))
    return reg


def advdiff_program(width: int, mode: str = "wrap", device="cuda"):
    """The app as a 2-core :class:`~repro_torch.core.program.StreamProgram`:
    advect → react/diffuse, fusion partition left to the DSE."""
    from repro_torch.core.program import StreamProgram

    return StreamProgram(
        build_advdiff_registry(width, mode),
        ["Advect2D", "ReactDiffuse2D"],
        width=width,
        name="AdvDiff_Program",
        device=device,
    )


# --------------------------------------------------------------------------
# Full-grid torch reference (the oracle)
# --------------------------------------------------------------------------


def advdiff_ref_step(u, vx, vy, alpha, r):
    """One advect→react/diffuse step, periodic boundaries, on ``u``'s
    device (scalars rounded to f32, as the JAX oracle's weak types are)."""
    vx, vy, alpha, r = (f32(v, u.device) for v in (vx, vy, alpha, r))
    a = (
        u
        - vx * (u - torch.roll(u, 1, dims=1))
        - vy * (u - torch.roll(u, 1, dims=0))
    )
    lap = (
        torch.roll(a, 1, dims=0) + torch.roll(a, -1, dims=0)
        + torch.roll(a, 1, dims=1) + torch.roll(a, -1, dims=1)
        - 4.0 * a
    )
    return a + alpha * lap + r * a * (1.0 - a)


def advdiff_ref_run(u, vx, vy, alpha, r, steps: int):
    for _ in range(steps):
        u = advdiff_ref_step(u, vx, vy, alpha, r)
    return u


def blob_init(h: int, w: int, amp: float = 0.8, device="cuda"):
    """A smooth periodic concentration blob in (0, amp]."""
    dev = resolve_device(device)
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    return amp * (
        0.5 + 0.25 * torch.sin(2 * math.pi * y / h)
        + 0.25 * torch.cos(2 * math.pi * x / w)
    )


# --------------------------------------------------------------------------
# The simulation
# --------------------------------------------------------------------------


class AdvectionDiffusionSimulation:
    """The counterpart of :class:`repro_torch.apps.lbm.LBMSimulation` for
    the 2-core program: holds the compiled registry, hands the explorer a
    program-backed workload (``stages`` set, so the model prices fusion
    partitions cluster by cluster), and runs the program's partitions.
    ``device`` is where :meth:`state` puts the packed state (``"cuda"``
    without a card raises; ``"cpu"`` runs the plain versions)."""

    def __init__(self, height: int, width: int, *, vx: float = 0.2,
                 vy: float = 0.1, alpha: float = 0.15, r: float = 0.05,
                 device="cuda"):
        if not 0.0 < alpha <= 0.25:
            raise ValueError(f"explicit scheme needs 0 < alpha <= 0.25, "
                             f"got {alpha}")
        if not (0.0 <= vx <= 1.0 and 0.0 <= vy <= 1.0):
            raise ValueError("upwind scheme needs 0 <= vx, vy <= 1")
        self.height, self.width = height, width
        self.vx, self.vy, self.alpha, self.r = vx, vy, alpha, r
        self.program = advdiff_program(width, device=device)
        self.registry = self.program.registry
        self.device = self.program.device

    @property
    def monolithic_core(self) -> CompiledCore:
        """The hand-written single-core AdvDiff2D reference."""
        return self.registry.lookup("AdvDiff2D")

    def regs(self) -> tuple:
        """Flat program register values (``vx, vy, alpha, r`` — also the
        monolithic core's register order)."""
        return (self.vx, self.vy, self.alpha, self.r)

    def state(self, u) -> torch.Tensor:
        """The (1, H, W) state of a concentration field (numpy or torch)."""
        return self.program.monolithic_kernel().pack(
            [from_numpy(u, self.device)])

    def explorer(self, **kw):
        """DSE explorer over the program (the fusion axis through
        ``sweep_gpu(fusion_values=...)``)."""
        return self.program.explorer(
            self.height * self.width, grid_w=self.width, **kw
        )

    def run(self, u, steps: int, *, fusion: str = "", m: int = 1,
            block_h: int = 32, d: int = 1):
        """Advance ``steps`` through the program under ``fusion``; ``d >
        1`` shards each cluster over ``cuda:0 … cuda:d-1`` (the CPU d
        times on the CPU)."""
        out = self.program.kernel(fusion).run_blocked(
            self.state(u), self.regs(), steps=steps, m=m,
            block_h=block_h, d=d,
        )
        return out[0]
