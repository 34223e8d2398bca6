"""The port's spatial parallelism on the CPU against the JAX package.

The pure helpers and the per-shard legalizer equal the reference's; each
halo launch's plain version equals the JAX ``spd_multistep_halo`` /
``spd_multistep_halo_streamed`` (Pallas interpret mode) on the same
guard-extended array at the cross-framework tolerance (rtol 2e-5, atol
1e-6) — on every column for a ring shard, on the kept columns for a
width-extended shard of a column-sharded mesh (the guard columns are
cropped, and the port wraps them where the reference zero-fills); the
reference's rejections raise here too, with its messages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro.core import distribute as jdist
from repro.core import legalize as jleg
from repro.kernels.spd_stream import (
    spd_multistep_halo as jax_halo,
    spd_multistep_halo_streamed as jax_halo_streamed,
)
from repro_torch import interop
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core import ShardedStreamKernel
from repro_torch.core import distribute as tdist
from repro_torch.core import legalize as tleg
from repro_torch.kernels.spd_stream import (
    spd_multistep_halo,
    spd_multistep_halo_streamed,
)

RTOL, ATOL = 2e-5, 1e-6
TGV_REGS = (1 / 0.8, 0.0, 1.0)


class _Point:
    def __init__(self, m, block_rows, **detail):
        self.m = m
        self.detail = {"block_rows": block_rows, **detail}


# ----------------------- pure helpers and plans -----------------------


def test_helpers_equal_the_reference():
    assert (tdist.DEVICE_AXIS, tdist.DEVICE_AXIS_X) == (
        jdist.DEVICE_AXIS, jdist.DEVICE_AXIS_X)
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert tdist.device_axis_values(n) == jdist.device_axis_values(n)
        assert tdist.mesh_axis_values(n) == jdist.mesh_axis_values(n)
    with pytest.raises(ValueError):
        tdist.device_axis_values(0)


_PLANS = [
    # h, width, words, block_rows, m, d, dx, halo, halo_x, db
    (64, 64, 1, 64, 2, 4, 1, 1, 1, True),
    (64, 64, 1, 12, 2, 4, 2, 1, 1, True),
    (300, 720, 10, 20, 4, 4, 2, 1, 1, True),
    (4096, 4096, 10, 16, 4, 4, 2, 1, 1, True),
    (8192, 8192, 1, 32, 4, 4, 1, 1, 1, False),
    (256, 640, 3, 32, 4, 8, 4, 1, 1, True),
    (128, 512, 1, 64, 8, 8, 8, 2, 3, True),
    (502, 100_000, 200, 251, 1, 2, 1, 1, 1, True),
    (30, 64, 1, 8, 2, 4, 1, 1, 1, True),
    (64, 70, 1, 8, 1, 4, 4, 1, 1, True),
    (64, 64, 1, 8, 1, 4, 3, 1, 1, True),
]


@pytest.mark.parametrize("h,width,words,bh,m,d,dx,halo,hx,db", _PLANS)
def test_per_shard_plans_equal_the_reference(h, width, words, bh, m, d, dx,
                                             halo, hx, db):
    kw = dict(halo=halo, width=width, words=words, d=d, dx=dx, halo_x=hx,
              double_buffer=db)
    try:
        want = jleg.blocking_plan(h, bh, m, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            tleg.blocking_plan(h, bh, m, **kw)
        return
    assert tleg.blocking_plan(h, bh, m, **kw) == want
    assert tleg.legal_block_values(
        h, m, halo=halo, width=width, words=words, d=d, dx=dx, halo_x=hx,
    ) == jleg.legal_block_values(
        h, m, halo=halo, width=width, words=words, d=d, dx=dx, halo_x=hx)
    pt = _Point(m, bh, double_buffer=db)
    for steps in (None, 3 * m + 1):
        args = dict(halo=halo, width=width, words=words, d=d, dx=dx,
                    halo_x=hx)
        assert (tleg.resolve_run_plan(h, pt, steps, **args)
                == jleg.resolve_run_plan(h, pt, steps, **args))


def test_sharded_run_for_point_takes_the_reference_plan():
    sim = tlbm.LBMSimulation(tlbm.LBMProblem(60, 48), device="cpu")
    kern = sim.stream_kernel()
    f, attr = tlbm.cavity_init(60, 48, device="cpu")
    state = sim.stream_state(f, attr)
    regs = (1 / 0.8, 0.05, 1.0)
    pt = _Point(2, 20)
    sk = kern.sharded(4, devices=["cpu"] * 4, dx=2)
    out, plan = sk.run_for_point(state, regs, point=pt, steps=4)
    bh, m, nsteps, db = jleg.resolve_run_plan(
        60, pt, 4, halo=1, width=48, words=10, d=4, dx=2, halo_x=1)
    assert plan == (bh, m, db) == (15, 2, True)
    assert torch.equal(out, kern.run_blocked(state, regs, steps=nsteps, m=m,
                                             block_h=bh))


# ----------------------- halo launches vs the JAX kernels ------------------


@pytest.fixture(scope="module")
def apps():
    """(port kernel, JAX kernel, ext (P, 24, 32) made with numpy, regs)
    per app; ext's rows are those of a periodic grid, so the uLBM PE
    divides by a physical rho in every row a stripe reads."""
    rng = np.random.default_rng(11)
    u0, _ = jdif.sine_init(24, 32)
    u = (np.asarray(u0) + 0.01 * rng.standard_normal((24, 32)))[None]
    f, attr, _ = jlbm.taylor_green_init(24, 32)
    f = np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, 24, 32)))
    pe = np.concatenate([f, np.asarray(attr)[None]]).astype(np.float32)
    return {
        "diffusion": (
            tdif.DiffusionSimulation(24, 32, device="cpu").kernel,
            jdif.DiffusionSimulation(24, 32).kernel,
            u.astype(np.float32), (0.2,)),
        "pe": (
            tlbm.LBMSimulation(tlbm.LBMProblem(24, 32),
                               device="cpu").stream_kernel(),
            jlbm.LBMSimulation(jlbm.LBMProblem(24, 32)).stream_kernel(),
            pe, TGV_REGS),
    }


@pytest.mark.parametrize("layout", ["ring", "guarded"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("app", ["diffusion", "pe"])
def test_halo_launches_match_jax_interpret(apps, app, m, layout):
    tk, jk, ext, regs = apps[app]
    step_fn = jk._step_fn if layout == "ring" else jk._step_fn_guarded
    cols = slice(None) if layout == "ring" else slice(m, 32 - m)
    x = torch.from_numpy(ext)
    for ours, theirs in ((spd_multistep_halo, jax_halo),
                         (spd_multistep_halo_streamed, jax_halo_streamed)):
        got = ours(tk.program, x, regs, m=m, block_h=4, block_w=16)
        want = theirs(step_fn, jnp.asarray(ext), jk._scal(regs), m=m,
                      block_h=4, halo=1, interpret=True)
        assert got.shape == (ext.shape[0], 16, 32)
        np.testing.assert_allclose(got.numpy()[:, :, cols],
                                   np.asarray(want)[:, :, cols],
                                   rtol=RTOL, atol=ATOL)


def test_halo_launches_agree_bitwise_and_write_into_out(apps):
    tk, _, ext, regs = apps["pe"]
    x = torch.from_numpy(ext)
    a = spd_multistep_halo(tk.program, x, regs, m=2, block_h=4)
    for bw, db in ((16, True), (7, False), (32, True)):
        assert torch.equal(spd_multistep_halo_streamed(
            tk.program, x, regs, m=2, block_h=4, block_w=bw,
            double_buffer=db), a)
    buf = torch.zeros((10, 20, 32))
    out = spd_multistep_halo(tk.program, x, regs, m=2, block_h=4,
                             out=buf[:, 2:18])
    assert out.data_ptr() == buf[:, 2:18].data_ptr()
    assert torch.equal(buf[:, 2:18], a)
    # A launch over a shard's own rows takes their first and last blocks
    # as guards and computes the blocks between, bitwise.
    inner = spd_multistep_halo(tk.program, x[:, 4:20], regs, m=2, block_h=4)
    assert torch.equal(inner, a[:, 4:12])


def test_halo_launch_rejections_match_the_reference(apps):
    tk, _, ext, regs = apps["diffusion"]
    x = torch.from_numpy(ext)
    for ours in (spd_multistep_halo, spd_multistep_halo_streamed):
        with pytest.raises(ValueError, match="not local_h"):
            ours(tk.program, x[:, :22], regs, m=1, block_h=4)
        with pytest.raises(ValueError, match="not local_h"):
            ours(tk.program, x[:, :8], regs, m=1, block_h=4)
        with pytest.raises(ValueError, match="halo source"):
            ours(tk.program, x, regs, m=5, block_h=4)


# ----------------------- the sharded kernel ------------------------------


@pytest.fixture(scope="module")
def dif():
    sim = tdif.DiffusionSimulation(16, 64, alpha=0.2, device="cpu")
    u0, _ = tdif.sine_init(16, 64, device="cpu")
    return sim, u0


def test_sharded_rejects_illegal_plans(dif):
    sim, u0 = dif
    state = sim.state(u0)
    sk = sim.kernel.sharded(2)
    with pytest.raises(ValueError, match="shards"):
        sk.run_blocked(state[:, :15, :], (0.2,), steps=1, m=1, block_h=5)
    with pytest.raises(ValueError, match="divisible"):
        sk.run_blocked(state, (0.2,), steps=1, m=1, block_h=3)
    with pytest.raises(ValueError, match="halo"):
        sk.run_blocked(state, (0.2,), steps=8, m=8, block_h=4)
    with pytest.raises(ValueError, match="multiple"):
        sk.run_blocked(state, (0.2,), steps=3, m=2, block_h=8)
    wide = sim.kernel.sharded(8, devices=["cpu"] * 8, dx=8)
    with pytest.raises(ValueError, match="shard width"):
        wide.run_blocked(state, (0.2,), steps=16, m=16, block_h=16)
    with pytest.raises(ValueError, match="column device axis|mesh"):
        sim.kernel.sharded(4, dx=3)


def test_sharded_rejects_a_state_off_the_mesh_device(dif):
    """The tensor's device picks the path: a state of another device type
    than the mesh's raises instead of being copied over to it."""
    sim, u0 = dif
    off = torch.empty(sim.state(u0).shape, device="meta")
    for sk in (sim.kernel.sharded(2),
               sim.kernel.sharded(4, devices=["cpu"] * 4, dx=2)):
        with pytest.raises(ValueError, match=r"state on meta but mesh on cpu"):
            sk.run_blocked(off, (0.2,), steps=2, m=2, block_h=4)
        with pytest.raises(ValueError, match="mesh on cpu"):
            sk.multistep(off, (0.2,), m=2, block_h=4)


def test_sharded_d1_delegates(dif):
    sim, u0 = dif
    state = sim.state(u0)
    sk = sim.kernel.sharded(1)
    assert isinstance(sk, ShardedStreamKernel) and sk.mesh is None
    assert torch.equal(
        sk.run_blocked(state, (0.2,), steps=2, m=2, block_h=8),
        sim.kernel.run_blocked(state, (0.2,), steps=2, m=2, block_h=8))
    assert sim.kernel.sharded(2) is sim.kernel.sharded(2)


def test_meshes_and_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert tdist.ring_mesh(3, ["cpu"] * 3) == [cpu] * 3
    assert tdist.device_mesh(2, 2, ["cpu"] * 5) == [[cpu] * 2] * 2
    with pytest.raises(ValueError, match="need 4 devices"):
        tdist.ring_mesh(4, ["cpu"] * 3)
    with pytest.raises(ValueError, match="device axis"):
        tdist.ring_mesh(0, ["cpu"])
    with pytest.raises(ValueError, match="mesh axes"):
        tdist.device_mesh(0, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match=r"\['cuda:0'\] \* 2"):
        tdist.ring_mesh(2)  # two cards asked of a machine with one
    with pytest.raises(RuntimeError, match="no CUDA device cuda:1"):
        interop.resolve_device("cuda:1")
    assert interop.resolve_devices(["cuda", "cuda:0"], 2) == [
        torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="mix"):
        interop.resolve_devices(["cuda:0", "cpu"], 2)


def test_diffusion_app_runs_sharded(dif):
    sim, u0 = dif
    got = sim.run(u0, 4, m=2, d=2)
    assert torch.equal(got, sim.run(u0, 4, m=2))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdif.diffusion_ref_run(u0.numpy(), 0.2, 4)),
        rtol=RTOL, atol=ATOL)
