"""The paper's uLBM PE (``repro_torch.apps.lbm``, core ``PEx1``).

State: ``(10, H, W)`` f32, the nine D2Q9 populations then ``attr``
(0 fluid, 1 wall, 2 lid), the layout of the PE's stream kernel. Register
values: ``(1 / tau, u_lid, rho0)``, the PE's ``Append_Reg`` order.
"""

from __future__ import annotations

import math

import torch

from bench.reference import d2q9

PLANES = 10


class System:
    def __init__(self, config: dict, grid, device):
        from repro_torch.apps import lbm

        h, w = grid
        self.config = config
        self.sim = lbm.LBMSimulation(
            lbm.LBMProblem(h, w, tau=config["tau"], mode="wrap"),
            device=device)
        self.kernel = self.sim.stream_kernel()
        self.grid = (h, w)
        self.device = self.kernel.device

    def explorer(self):
        return self.sim.explorer()

    def regs(self, tenant: dict) -> tuple:
        return (1.0 / self.config["tau"], float(tenant.get("u_lid", 0.0)),
                float(self.config["rho0"]))

    def states(self, init: dict, count: int, gen) -> torch.Tensor:
        """``count`` initial states ``(count, 10, H, W)`` of the mix's
        ``init``, drawn on the device from ``gen``."""
        h, w = self.grid
        dev = self.device
        rho = 1.0 + init["rho_noise"] * (
            2.0 * torch.rand((count, h, w), generator=gen, device=dev) - 1.0)
        attr = torch.zeros((count, h, w), device=dev)
        if init["kind"] == "taylor_green":
            phase = 2 * math.pi * torch.rand((count, 2, 1, 1), generator=gen,
                                             device=dev)
            y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            n = init["periods"]
            kx, ky = 2 * math.pi * n / w, 2 * math.pi * n / h
            ax, ay = kx * x + phase[:, 0], ky * y + phase[:, 1]
            u0 = init["u0"]
            ux = -u0 * torch.cos(ax) * torch.sin(ay)
            uy = u0 * (kx / ky) * torch.sin(ax) * torch.cos(ay)
        elif init["kind"] == "cavity_rest":
            # The paper's lid-driven cavity: walls left, right and bottom,
            # the lid the top row, the fluid at rest.
            attr[:, 0, :] = 1.0
            attr[:, :, 0] = 1.0
            attr[:, :, -1] = 1.0
            attr[:, -1, :] = 2.0
            ux = uy = torch.zeros_like(rho)
        else:
            raise ValueError(f"uLBM PE: unknown init {init['kind']!r}")
        f = d2q9.equilibrium(rho, ux, uy)
        return torch.cat([f, attr[:, None]], dim=1).contiguous()

    def reference(self, state, tenant: dict, steps: int,
                  dtype=torch.float32):
        """``state`` ``([B,] 10, H, W)`` advanced ``steps`` steps by the plain
        reference in ``dtype``; returned in f32, attr carried through."""
        f = state[..., :9, :, :].to(dtype)
        attr = state[..., 9, :, :].to(dtype)
        f = d2q9.run(f, attr, steps, tau=self.config["tau"],
                     u_lid=float(tenant.get("u_lid", 0.0)),
                     rho0=float(self.config["rho0"]))
        return torch.cat([f, attr.unsqueeze(-3)], dim=-3).float()


def build(config: dict, grid, device) -> System:
    return System(config, grid, device)
