"""The port's (dy × dx) device mesh on the CPU: sharded ≡ single device.

The reference's mesh matrix (``tests/test_mesh.py``) needs forced host
devices and skips without them; the port's mesh is a device list that
may repeat a device, so here every case runs on ``["cpu"] * d`` — every
halo launch, exchange, corner hop and crop for real — and is held to the
port's single-device run **bit for bit**: each launch runs the same
tile function, and each block's stripe holds the same values. A few
sharded runs are also held to the JAX package's single-device run at the
cross-framework tolerance (rtol 2e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm

#: The reference's mesh matrix: row-only, column-only and 2-D meshes.
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4))

FLUID_REGS = (1 / 0.8, 0.0, 1.0)
COUETTE_REGS = (1 / 0.9, 0.07, 1.0)
H, W = 16, 64


@pytest.fixture(scope="module")
def kernels():
    """The port's kernels, and each app's state made with numpy."""
    dsim = tdif.DiffusionSimulation(H, W, alpha=0.2, device="cpu")
    lsim = tlbm.LBMSimulation(tlbm.LBMProblem(H, W), device="cpu")
    rng = np.random.default_rng(3)
    u0, _ = jdif.sine_init(H, W)
    u = np.asarray(u0) + 0.01 * rng.standard_normal((H, W))
    f, attr, _ = jlbm.taylor_green_init(H, W)
    fc, attrc = jlbm.couette_init(H, W)
    lk = lsim.stream_kernel()
    return {
        "diffusion": (dsim.kernel, dsim.state(u.astype(np.float32)),
                      (0.2,)),
        "fluid": (lk, lsim.stream_state(np.asarray(f), np.asarray(attr)),
                  FLUID_REGS),
        "couette": (lk, lsim.stream_state(np.asarray(fc),
                                          np.asarray(attrc)),
                    COUETTE_REGS),
    }


@pytest.mark.parametrize("db", [True, False], ids=["db", "single"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dy,dx", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("app", ["diffusion", "fluid", "couette"])
def test_mesh_equals_single_device(kernels, app, dy, dx, m, db):
    kern, state, regs = kernels[app]
    single = kern.run_blocked(state, regs, steps=2 * m, m=m, block_h=2,
                              double_buffer=db)
    sk = kern.sharded(dy * dx, devices=["cpu"] * (dy * dx), dx=dx)
    meshed = sk.run_blocked(state, regs, steps=2 * m, m=m, block_h=2,
                            double_buffer=db)
    assert torch.equal(meshed, single)


@pytest.mark.parametrize("dy,dx", [(1, 2), (2, 2), (4, 1)])
@pytest.mark.parametrize("app", ["diffusion", "fluid"])
def test_each_shard_takes_one_launch_a_fused_step(kernels, app, dy, dx,
                                                  monkeypatch):
    """Every fused step launches each shard once, over its whole
    guard-extended buffer (block_h guard rows a side), into its own rows
    of the other buffer; shards of 16/dy rows at block_h 2 hold 2 to 8
    blocks."""
    from repro_torch.kernels.spd_stream import streaming

    kern, state, regs = kernels[app]
    single = kern.run_blocked(state, regs, steps=4, m=2, block_h=2)
    launch = streaming.spd_multistep_halo_streamed
    seen = []

    def spy(program, ext, regs, *, out, **kw):
        seen.append((tuple(ext.shape[-2:]), tuple(out.shape[-2:])))
        return launch(program, ext, regs, out=out, **kw)

    monkeypatch.setattr(streaming, "spd_multistep_halo_streamed", spy)
    sk = kern.sharded(dy * dx, devices=["cpu"] * (dy * dx), dx=dx)
    got = sk.run_blocked(state, regs, steps=4, m=2, block_h=2)
    lh, lw = H // dy, W // dx
    ew = lw + 2 * 2 * kern.halo_x if dx > 1 else lw
    assert seen == [((lh + 2 * 2, ew), (lh, ew))] * (dy * dx * 2)
    assert torch.equal(got, single)


@pytest.mark.parametrize("block_h", [4, 8], ids=["2blocks", "1block"])
def test_shards_of_one_or_two_blocks_equal_single(kernels, block_h):
    """8-row shards of 2 blocks, then of 1: the launch over a shard's
    guard-extended buffer needs no interior block."""
    kern, state, regs = kernels["diffusion"]
    single = kern.run_blocked(state, regs, steps=2, m=1, block_h=block_h)
    sk = kern.sharded(2, devices=["cpu"] * 2)
    assert torch.equal(sk.run_blocked(state, regs, steps=2, m=1,
                                      block_h=block_h), single)


@pytest.mark.parametrize("dy,dx", [(2, 2), (1, 4)])
@pytest.mark.parametrize("app", ["diffusion", "couette"])
def test_declarative_twin_equals_streamed(kernels, app, dy, dx):
    kern, state, regs = kernels[app]
    sk = kern.sharded(dy * dx, devices=["cpu"] * (dy * dx), dx=dx)
    assert torch.equal(sk.multistep(state, regs, m=2, block_h=2),
                       sk.run_blocked(state, regs, steps=2, m=2, block_h=2))


@pytest.mark.parametrize("dy,dx,app", [
    (2, 2, "diffusion"), (4, 1, "fluid"), (2, 4, "couette"),
])
def test_mesh_matches_jax_single_device(kernels, dy, dx, app):
    kern, state, regs = kernels[app]
    got = kern.sharded(dy * dx, devices=["cpu"] * (dy * dx),
                       dx=dx).run_blocked(state, regs, steps=4, m=2,
                                          block_h=4)
    if app == "diffusion":
        jk = jdif.DiffusionSimulation(H, W, alpha=0.2).kernel
    else:
        jk = jlbm.LBMSimulation(jlbm.LBMProblem(H, W)).stream_kernel()
    want = jk.run_blocked(state.numpy(), regs, steps=4, m=2, block_h=4,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


def test_elementwise_core_shards_without_exchange():
    """A core with no stencil (halo 0) takes the periodic launch per
    shard; an x-only stencil exchanges columns only and crops."""
    from repro_torch.core import Registry, parse_spd

    for body, halo in (("EQU N1, v = u*0.5 + 1.0;", 0),
                       ("HDL S1, 0, (t) = Stencil2D(u), dy=0, dx=1, W=32, "
                        "mode=wrap;\nEQU N1, v = t*0.5 + u;", 0)):
        kern = Registry().compile(parse_spd(
            "Name Pt;\nMain_In {mi::u};\nMain_Out {mo::v};\n" + body
        )).stream_kernel(device="cpu")
        assert kern.halo == halo
        state = kern.pack([np.random.default_rng(1).standard_normal((8, 32))])
        want = kern.run_blocked(state, steps=4, m=2, block_h=2)
        for dy, dx in ((2, 1), (2, 2), (1, 4)):
            got = kern.sharded(dy * dx, devices=["cpu"] * (dy * dx),
                               dx=dx).run_blocked(state, steps=4, m=2,
                                                  block_h=2)
            assert torch.equal(got, want), (body, dy, dx)
