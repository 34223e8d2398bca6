"""The frozen references against the port's own reference function.

``StreamKernel.reference`` applies the compiled SPD core's torch function
on the full grid; the benchmark's references are written anew from the
published equations. On the CPU they agree to f32 rounding.
"""

import json

import pytest
import torch

from bench import harness
from bench.apps import diffusion_5pt, ulbm_pe
from bench.reference import d2q9, diffusion

TOL = 2e-6


def _config(name):
    return json.loads((harness.BENCH / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("init,tenant", [
    ({"kind": "taylor_green", "u0": 0.05, "periods": 2, "rho_noise": 1e-2},
     {"u_lid": 0.0}),
    ({"kind": "cavity_rest", "rho_noise": 1e-2}, {"u_lid": 0.1}),
])
def test_d2q9_matches_the_pe(init, tenant):
    system = ulbm_pe.build(_config("ulbm-pe-d2q9"), (16, 24), "cpu")
    gen = torch.Generator().manual_seed(5)
    state = system.states(init, 1, gen)[0]
    regs = system.regs(tenant)
    for steps in (1, 8):
        want = system.kernel.reference(state, regs, m=steps)
        got = system.reference(state, tenant, steps)
        assert (got - want).abs().max() <= TOL
        assert torch.equal(got[9], state[9])
    assert (state[9] == 2).sum() == (24 if init["kind"] == "cavity_rest"
                                     else 0)


@pytest.mark.parametrize("alpha", [0.2, 0.1])
def test_diffusion_matches_the_core(alpha):
    system = diffusion_5pt.build(_config("diffusion-5pt"), (16, 24), "cpu")
    gen = torch.Generator().manual_seed(6)
    state = system.states({"kind": "random_field"}, 1, gen)[0]
    for steps in (1, 8):
        want = system.kernel.reference(state, (alpha,), m=steps)
        got = system.reference(state, {"alpha": alpha}, steps)
        assert (got - want).abs().max() <= TOL


def test_references_take_a_batch():
    gen = torch.Generator().manual_seed(7)
    f = 0.1 + 0.01 * torch.rand((3, 9, 8, 12), generator=gen)
    attr = torch.zeros((3, 8, 12))
    attr[1, 0, :] = 1.0
    attr[2, -1, :] = 2.0
    batched = d2q9.run(f, attr, 4, tau=0.8, u_lid=0.05)
    for b in range(3):
        assert torch.equal(batched[b], d2q9.run(f[b], attr[b], 4, tau=0.8,
                                                u_lid=0.05))
    u = torch.rand((2, 8, 12), generator=gen)
    got = diffusion.run(u, 5, alpha=0.2)
    assert torch.equal(got[1], diffusion.run(u[1], 5, alpha=0.2))


def test_d2q9_conserves_mass_and_decays_a_vortex():
    """Physics anchors: BGK conserves mass on a periodic grid, and a
    Taylor-Green vortex decays at the rate nu k^2 of its viscosity."""
    h = w = 32
    y = torch.arange(h, dtype=torch.float64)[:, None]
    x = torch.arange(w, dtype=torch.float64)[None, :]
    k = 2 * torch.pi / w
    u0, tau = 0.01, 0.8
    ux = -u0 * torch.cos(k * x) * torch.sin(k * y)
    uy = u0 * torch.sin(k * x) * torch.cos(k * y)
    f = d2q9.equilibrium(torch.ones((h, w), dtype=torch.float64), ux, uy)
    attr = torch.zeros((h, w), dtype=torch.float64)
    out = d2q9.run(f, attr, 200, tau=tau)
    assert out.sum().item() == pytest.approx(f.sum().item(), rel=1e-12)
    nu = (tau - 0.5) / 3
    energy = lambda g: ((g[[1, 5, 8]].sum(0) - g[[3, 6, 7]].sum(0)) ** 2
                        ).sum().item()  # noqa: E731
    ratio = energy(out) / energy(f)
    assert ratio == pytest.approx(
        torch.exp(torch.tensor(-2 * nu * 2 * k * k * 200)).item(), rel=0.02)
