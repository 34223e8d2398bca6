"""The port's LBM app and hand-written kernel against the JAX package,
and the physics anchors of ``tests/test_lbm.py`` held through the port.

Tolerance rtol 2e-5 / atol 1e-6 unless stated: XLA on the CPU and torch
round the same operations at the same points, but sums over the nine
populations may be taken in another order.
"""

import math

import numpy as np
import pytest
import torch

from repro.apps import lbm as jlbm
from repro_torch.apps import lbm as tlbm
from repro_torch.kernels.lbm_stream.ops import (
    lbm_multistep,
    lbm_multistep_ref,
    lbm_run_blocked,
    lbm_run_for_point,
)

RTOL, ATOL = 2e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("m,block_h", [(1, 8), (4, 8)])
def test_handwritten_plain_matches_jax_interpret(m, block_h):
    """The hand-written kernel's plain version against the JAX Pallas
    kernel in interpret mode, walls and moving lid included."""
    from repro.kernels.lbm_stream.lbm_stream import lbm_multistep as jms

    f, attr = jlbm.couette_init(16, 128)
    rng = np.random.default_rng(3)
    f = np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, 16, 128)))
    f = f.astype(np.float32)
    got = lbm_multistep(_t(f), _t(attr), 1 / 0.9, 0.07, m=m,
                        block_h=block_h)
    want = jms(f, attr, 1 / 0.9, 0.07, m=m, block_h=block_h,
               interpret=True)
    _close(got, want)


def test_handwritten_plain_matches_generated_pe():
    """The generated uLBM PE and the hand-written kernel agree to the
    tolerance ``tests/test_codegen.py`` holds the JAX pair to."""
    sim = tlbm.LBMSimulation(tlbm.LBMProblem(16, 128), device="cpu")
    f, attr = tlbm.couette_init(16, 128, device="cpu")
    got = sim.stream_kernel()(sim.stream_state(f, attr), (1 / 0.9, 0.07, 1.0),
                              m=4, block_h=8)
    hand = lbm_multistep(f, attr, 1 / 0.9, 0.07, m=4, block_h=8)
    _close(got[:9], hand, rtol=2e-5, atol=1e-7)


def test_run_blocked_and_point_match_reference():
    f, attr, _ = tlbm.taylor_green_init(16, 96, device="cpu")
    want = lbm_multistep_ref(f, attr, 1 / 0.8, 0.0, 8)
    got = lbm_run_blocked(f, attr, 1 / 0.8, steps=8, m=4, block_h=8)
    _close(got, want)
    ragged = lbm_multistep(f, attr, 1 / 0.8, 0.0, m=4, block_h=8, block_w=40)
    assert torch.equal(ragged, lbm_multistep(f, attr, 1 / 0.8, 0.0, m=4,
                                             block_h=8, block_w=96))

    class Point:
        m, detail = 4, {"block_rows": 16}

    out, plan = lbm_run_for_point(f, attr, 1 / 0.8, Point(), steps=8)
    assert plan == (16, 4)
    assert torch.equal(out, lbm_run_blocked(f, attr, 1 / 0.8, steps=8,
                                            m=4, block_h=16))


@pytest.mark.parametrize("mode", ["wrap", "zero"])
def test_reference_step_matches_jax(mode):
    f, attr = jlbm.cavity_init(12, 10)
    rng = np.random.default_rng(5)
    f = (np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, 12, 10))))
    f = f.astype(np.float32)
    got = tlbm.ref_run(_t(f), _t(attr), 1 / 0.9, 3, u_lid=0.07, mode=mode)
    want = jlbm.ref_run(f, attr, 1 / 0.9, steps=3, u_lid=0.07, mode=mode)
    _close(got, want)
    for a, b in zip(tlbm.macroscopics(got), jlbm.macroscopics(want)):
        _close(a, b)


def test_inits_match_jax():
    for t, j in zip(tlbm.taylor_green_init(16, 24, device="cpu"),
                    jlbm.taylor_green_init(16, 24)):
        if isinstance(j, float):
            assert t == pytest.approx(j)
        else:
            _close(t, j)
    for t, j in zip(tlbm.cavity_init(8, 8, device="cpu"),
                    jlbm.cavity_init(8, 8)):
        _close(t, j)


@pytest.mark.parametrize("bndry", ["hdl", "spd"])
def test_spd_pe_run_matches_jax(bndry):
    prob = dict(height=12, width=10, tau=0.9, u_lid=0.07, mode="zero")
    tsim = tlbm.LBMSimulation(tlbm.LBMProblem(**prob), m=2, bndry=bndry,
                              device="cpu")
    jsim = jlbm.LBMSimulation(jlbm.LBMProblem(**prob), m=2, bndry=bndry)
    f, attr = jlbm.couette_init(12, 10)
    got = tsim.run(_t(f), _t(attr), 4)
    want = jsim.run(f, attr, 4)
    _close(got, want, atol=1e-7)


def test_collision_conserves_mass_momentum():
    rng = np.random.default_rng(0)
    f = _t(rng.uniform(0.01, 0.2, size=(9, 16, 16)))
    fc = tlbm.collide(f, 1.0 / 0.8)
    for a, b, tol in zip(tlbm.macroscopics(fc), tlbm.macroscopics(f),
                         ((1e-5, 0), (1e-4, 1e-6), (1e-4, 1e-6))):
        _close(a, b, *tol)


def test_taylor_green_decay_through_the_stream_kernel():
    """Kinetic energy decays as exp(-2 nu k^2 t), rel 0.02, with every
    step taken by the generated kernel's plain version."""
    h = w = 64
    tau = 0.8
    f, attr, ksq = tlbm.taylor_green_init(h, w, u0=0.02, device="cpu")
    sim = tlbm.LBMSimulation(tlbm.LBMProblem(h, w, tau=tau), device="cpu")
    kern = sim.stream_kernel()
    e0 = tlbm.tgv_kinetic_energy(f)
    steps = 200
    out = kern.run_blocked(sim.stream_state(f, attr), sim.stream_regs(),
                           steps=steps, m=4, block_h=32)
    e1 = tlbm.tgv_kinetic_energy(out[:9])
    expected = e0 * math.exp(-2.0 * tlbm.viscosity(tau) * ksq * steps)
    assert e1 == pytest.approx(expected, rel=0.02)


def test_couette_linear_profile():
    """Steady Couette flow between a static and a moving wall is linear
    (atol 2.5e-3, as the JAX package holds it)."""
    h, w = 18, 8
    u_lid = 0.05
    f, attr = tlbm.couette_init(h, w, device="cpu")
    f = tlbm.ref_run(f, attr, 1.0 / 0.9, steps=4000, u_lid=u_lid)
    _, ux, _ = tlbm.macroscopics(f)
    prof = ux.mean(dim=1).numpy()[1:-1]
    y = (np.arange(1, h - 1) - 0.5) / (h - 2)
    np.testing.assert_allclose(prof, u_lid * y, atol=2.5e-3)


def test_lbm_run_for_point_on_a_tile_taller_than_the_owners_hold():
    """A point whose tile holds more stripe cells than the kernel's
    threads own in registers (block_rows 300 at m 4: 308 × 9 cells) runs,
    and equals the JAX package's ``lbm_run_for_point`` in interpret mode;
    both legalizers resolve the same plan. ``lbm_multistep`` at H 256,
    block_h 256, m 4 runs too."""
    from repro.core.legalize import resolve_run_plan as jplan
    from repro.kernels.lbm_stream.ops import lbm_run_for_point as jrun
    from repro_torch.core.legalize import resolve_run_plan
    from repro_torch.kernels.lbm_stream.lbm_stream import lbm_owned

    class Point:
        m, detail = 4, {"block_rows": 300}

    f, attr = jlbm.cavity_init(300, 64)
    rng = np.random.default_rng(11)
    f = (np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, 300, 64))))
    f = f.astype(np.float32)
    attr = np.asarray(attr)
    plan = resolve_run_plan(300, Point(), 8)
    assert plan == (300, 4, 8, True) == jplan(300, Point(), 8)
    got, tplan = lbm_run_for_point(_t(f), _t(attr), 1 / 0.9, Point(),
                                   steps=8, u_lid=0.05)
    want, wplan = jrun(f, attr, 1 / 0.9, Point(), steps=8, u_lid=0.05,
                       interpret=True)
    assert tplan == wplan == (300, 4)
    assert not lbm_owned(300, 1, 4)
    _close(got, want)
    g = _t(f[:, :256])
    out = lbm_multistep(g, _t(attr[:256]), 1 / 0.9, 0.05, m=4, block_h=256)
    assert out.shape == g.shape and torch.isfinite(out).all()
