"""The 5-point diffusion core (``repro_torch.apps.diffusion``, ``Diff2D``).

State: ``(1, H, W)`` f32. Register values: ``(alpha,)``.
"""

from __future__ import annotations

import torch

from bench.reference import diffusion

PLANES = 1


class System:
    def __init__(self, config: dict, grid, device):
        from repro_torch.apps import diffusion as dif

        h, w = grid
        self.config = config
        self.sim = dif.DiffusionSimulation(h, w, alpha=config["alpha"],
                                           device=device)
        self.kernel = self.sim.kernel
        self.grid = (h, w)
        self.device = self.kernel.device

    def explorer(self):
        return self.sim.explorer()

    def regs(self, tenant: dict) -> tuple:
        return (float(tenant.get("alpha", self.config["alpha"])),)

    def states(self, init: dict, count: int, gen) -> torch.Tensor:
        """``count`` uniform random fields in [0, 1), ``(count, 1, H, W)``."""
        if init["kind"] != "random_field":
            raise ValueError(f"diffusion: unknown init {init['kind']!r}")
        h, w = self.grid
        return torch.rand((count, 1, h, w), generator=gen,
                          device=self.device)

    def reference(self, state, tenant: dict, steps: int,
                  dtype=torch.float32):
        alpha = float(tenant.get("alpha", self.config["alpha"]))
        return diffusion.run(state.to(dtype), steps, alpha=alpha).float()


def build(config: dict, grid, device) -> System:
    return System(config, grid, device)
