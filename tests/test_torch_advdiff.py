"""The port's advection-diffusion app (``repro_torch.apps
.advection_diffusion``) against the JAX package's.

The same numpy inputs (the blob plus seeded noise) go through the JAX
program in interpret mode and the port's on the CPU: every fusion
partition at m 2, and the two full-grid oracles, within rtol 2e-5 / atol
1e-6 (XLA and torch round the same f32 operations, but ``sin``/``cos`` and
the rolled sums may differ in the last bit). Inside the port every
partition stays within the reference's atol 1e-5 of the torch oracle.
"""

import numpy as np
import pytest
import torch

from repro.apps import advection_diffusion as jad
from repro_torch.apps import advection_diffusion as tad
from repro_torch.core.program import fusion_partitions

H, W = 16, 64
STEPS = 4
RTOL, ATOL = 2e-5, 1e-6


def _u0() -> np.ndarray:
    rng = np.random.default_rng(2)
    return (np.asarray(jad.blob_init(H, W))
            + 0.01 * rng.standard_normal((H, W))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX program, every partition at m 2, on the same numpy input."""
    sim = jad.AdvectionDiffusionSimulation(H, W)
    state = sim.state(_u0())
    return {
        spec: np.asarray(sim.program.kernel(spec).run_blocked(
            state, sim.regs(), steps=STEPS, m=2, block_h=8, interpret=True))
        for spec in fusion_partitions(sim.program.nstages)
    }


@pytest.fixture(scope="module")
def sim():
    return tad.AdvectionDiffusionSimulation(H, W, device="cpu")


@pytest.mark.parametrize("spec", fusion_partitions(2))
def test_partitions_match_jax(sim, jax_runs, spec):
    got = sim.program.kernel(spec).run_blocked(
        sim.state(_u0()), sim.regs(), steps=STEPS, m=2, block_h=8)
    np.testing.assert_allclose(got.numpy(), jax_runs[spec], rtol=RTOL,
                               atol=ATOL)


def test_spd_texts_match_jax():
    for mode in ("wrap", "zero"):
        assert tad.advect_spd(W, mode) == jad.advect_spd(W, mode)
        assert tad.react_diffuse_spd(W, mode) == jad.react_diffuse_spd(W,
                                                                        mode)
        assert tad.advdiff_spd(W, mode) == jad.advdiff_spd(W, mode)
    assert tad.NEIGHBORS == jad.NEIGHBORS


def test_blob_init_matches_jax():
    np.testing.assert_allclose(tad.blob_init(H, W, device="cpu").numpy(),
                               np.asarray(jad.blob_init(H, W)), rtol=RTOL,
                               atol=ATOL)
    got = tad.blob_init(32, 48, amp=0.5, device="cpu")
    assert got.shape == (32, 48) and got.dtype == torch.float32
    assert -1e-6 < float(got.min()) and float(got.max()) <= 0.5


def test_oracle_matches_jax(sim):
    u0 = _u0()
    args = (sim.vx, sim.vy, sim.alpha, sim.r)
    got = tad.advdiff_ref_run(torch.from_numpy(u0), *args, STEPS)
    want = jad.advdiff_ref_run(u0, *args, STEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    one = tad.advdiff_ref_step(torch.from_numpy(u0), *args)
    np.testing.assert_allclose(one.numpy(),
                               np.asarray(jad.advdiff_ref_step(u0, *args)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec", fusion_partitions(2))
def test_partitions_match_torch_oracle(sim, spec):
    """The reference's oracle test: each partition through
    ``AdvectionDiffusionSimulation.run`` within atol 1e-5 of the oracle,
    on one device and on a 2-shard CPU ring (bitwise equal)."""
    u0 = torch.from_numpy(_u0())
    want = tad.advdiff_ref_run(u0, sim.vx, sim.vy, sim.alpha, sim.r, STEPS)
    got = sim.run(u0, STEPS, fusion=spec, m=2, block_h=8)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(sim.run(u0, STEPS, fusion=spec, m=2, block_h=8, d=2),
                       got)


def test_simulation_contract():
    with pytest.raises(ValueError, match="alpha"):
        tad.AdvectionDiffusionSimulation(H, W, alpha=0.3, device="cpu")
    with pytest.raises(ValueError, match="upwind"):
        tad.AdvectionDiffusionSimulation(H, W, vx=-0.1, device="cpu")
    sim = tad.AdvectionDiffusionSimulation(H, W, device="cpu")
    assert sim.regs() == (0.2, 0.1, 0.15, 0.05)
    assert sim.monolithic_core.core.name == "AdvDiff2D"
    assert sim.state(np.zeros((H, W), np.float32)).shape == (1, H, W)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tad.AdvectionDiffusionSimulation(H, W)
    wl = sim.explorer().workload
    assert wl.stages and wl.halo == 2 and wl.cluster_tiles
