"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a card. On the machine with one
(``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``)
every kernel is built from ``src/repro_torch/csrc`` and held to its plain
torch version on the same CUDA inputs. Both round the same f32 operations
in the same order (``-fmad=false``), so the comparisons are bitwise.
"""

import pytest
import torch

from repro_torch.apps import diffusion as dif
from repro_torch.apps import lbm
from repro_torch.core.legalize import tile_smem_bytes
from repro_torch.kernels.lbm_stream.lbm_stream import (
    lbm_multistep,
    lbm_multistep_plain,
)
from repro_torch.kernels.spd_stream.spd_stream import spd_multistep_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [1, 2, 4])
def test_diffusion_kernel_equals_plain(card, m):
    sim = dif.DiffusionSimulation(64, 200)
    u0, _ = dif.sine_init(64, 200)
    st = sim.state(u0)
    want = spd_multistep_plain(sim.kernel.program, st, (0.2,), m=m,
                               block_h=16, block_w=64)
    for db in (True, False):
        got = sim.kernel(st, (0.2,), m=m, block_h=16, block_w=64,
                         double_buffer=db)
        assert torch.equal(got, want)
    assert torch.equal(sim.kernel.multistep(st, (0.2,), m=m, block_h=16,
                                            block_w=64), want)


@pytest.mark.parametrize("case", ["tgv", "couette"])
@pytest.mark.parametrize("m", [1, 4])
def test_ulbm_and_handwritten_equal_plain(card, case, m):
    sim = lbm.LBMSimulation(lbm.LBMProblem(64, 96))
    kern = sim.stream_kernel()
    if case == "tgv":
        f, attr, _ = lbm.taylor_green_init(64, 96)
        regs = (1 / 0.8, 0.0, 1.0)
    else:
        f, attr = lbm.couette_init(64, 96)
        regs = (1 / 0.9, 0.07, 1.0)
    state = sim.stream_state(f, attr)
    want = spd_multistep_plain(kern.program, state, regs, m=m, block_h=16,
                               block_w=32)
    assert torch.equal(kern(state, regs, m=m, block_h=16, block_w=32), want)
    assert torch.equal(kern.multistep(state, regs, m=m, block_h=16,
                                      block_w=32), want)
    assert torch.equal(kern(state, regs, m=m, block_h=8, block_w=48), want)
    hand = lbm_multistep(f, attr, regs[0], regs[1], m=m, block_h=16)
    assert torch.equal(hand, lbm_multistep_plain(
        f, attr, regs[0], regs[1], m=m, block_h=16, block_w=64))
    torch.testing.assert_close(want[:9], hand, rtol=2e-5, atol=1e-7)


def test_smem_pricing_equals_the_kernels(card):
    """The legalizer's planes, guard rows and owner cells are the
    kernel's own: the uLBM PE holds P + K = 19 planes in either launch
    and owns 2,048 cells in registers; diffusion ping/pongs two shared
    planes, plus the streamed launch's second slot."""
    kern = lbm.LBMSimulation(lbm.LBMProblem(64, 96)).stream_kernel()
    dprog = dif.DiffusionSimulation(64, 96).kernel.program
    for prog in (kern.program, dprog):
        lib = prog.library()
        assert lib.spd_owner_cells() == prog.owner_cells
        for streamed in (0, 1):
            for db in (0, 1):
                planes = prog.launch_planes(streamed=bool(streamed),
                                            double_buffer=bool(db))
                assert lib.spd_tile_planes(streamed, db) == planes
                for bh, bw, m in ((16, 32, 4), (16, 64, 4), (8, 96, 1)):
                    assert lib.spd_smem_bytes(bh, bw, m, planes) == \
                        prog.smem_bytes(bh, bw, m, streamed=bool(streamed),
                                        double_buffer=bool(db))
    assert kern.program.owner_cells == 2048 and dprog.owner_cells == 0
    assert kern.program.launch_planes(streamed=True, double_buffer=True) \
        == 19


#: (H, W, block_h, block_w, m) of the kernels' copy paths: the 16-byte
#: path with tiles on both periodic edges, a ragged last column tile on it,
#: a width that is not a multiple of 4 (the 4-byte path), m from 1 to 4
#: (m·halo_x off a multiple of 4 is the 4-byte path too), m·halo ==
#: block_h, and a grid of fewer tiles than persistent blocks.
COPY_CASES = {
    "vec4": (64, 96, 16, 32, 4),
    "ragged": (64, 104, 16, 32, 4),
    "width98": (32, 98, 8, 32, 4),
    "m1": (32, 96, 8, 32, 1),
    "m2": (32, 96, 8, 32, 2),
    "m3": (48, 96, 16, 24, 3),
    "m_eq_block_h": (32, 96, 4, 32, 4),
    "few_tiles": (16, 32, 16, 32, 2),
}


def _noisy(x, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return x * (1 + 0.01 * torch.randn(x.shape, generator=g).to(x.device))


def _pe(h, w):
    sim = lbm.LBMSimulation(lbm.LBMProblem(h, w))
    f, attr = lbm.couette_init(h, w)
    return sim, _noisy(f, 1), attr, (1 / 0.9, 0.07, 1.0)


@pytest.mark.parametrize("case", list(COPY_CASES))
def test_copy_paths_equal_plain(card, case):
    """Both stream kernels on every copy path: the generated kernels
    (diffusion and the uLBM PE; streamed with and without the prefetch
    slot, declarative) and the hand-written LBM kernel, bitwise equal to
    their plain versions."""
    h, w, bh, bw, m = COPY_CASES[case]
    dsim = dif.DiffusionSimulation(h, w)
    st = dsim.state(_noisy(dif.sine_init(h, w)[0], 0))
    sim, f, attr, regs = _pe(h, w)
    pe = sim.stream_kernel()
    for kern, state, rg in ((dsim.kernel, st, (0.2,)),
                            (pe, sim.stream_state(f, attr), regs)):
        want = spd_multistep_plain(kern.program, state, rg, m=m,
                                   block_h=bh, block_w=bw)
        for db in (True, False):
            assert torch.equal(kern(state, rg, m=m, block_h=bh, block_w=bw,
                                    double_buffer=db), want), (case, db)
        assert torch.equal(kern.multistep(state, rg, m=m, block_h=bh,
                                          block_w=bw), want), case
    want = lbm_multistep_plain(f, attr, regs[0], regs[1], m=m, block_h=bh,
                               block_w=bw)
    assert torch.equal(lbm_multistep(f, attr, regs[0], regs[1], m=m,
                                     block_h=bh, block_w=bw), want), case


def test_lbm_pricing_equals_the_kernel(card):
    from repro_torch.kernels.build import load_lbm_library
    from repro_torch.kernels.lbm_stream.lbm_stream import (
        LBM_CELLS,
        LBM_PLANES,
    )

    lib = load_lbm_library()
    assert lib.lbm_max_cells() == LBM_CELLS
    for bh, bw, m in ((16, 64, 4), (8, 32, 1), (20, 64, 4)):
        assert lib.lbm_smem_bytes(bh, bw, m) == tile_smem_bytes(
            bh, bw, m, halo=1, halo_x=1, planes=LBM_PLANES)


#: (H, W, block_h, block_w, m) of uLBM PE tiles with more stripe cells
#: than the 2,048 its threads own: 20 × 132 on the 16-byte path, 28 × 102
#: on the 4-byte path (W 98), 40 × 72 with a ragged last column tile and
#: fewer tiles than persistent blocks.
FALLBACK_CASES = {
    "vec4": (64, 256, 16, 128, 2),
    "width98": (96, 98, 24, 98, 2),
    "ragged": (96, 104, 32, 64, 4),
}


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_register_state_fallback_equals_plain(card, case):
    """A uLBM PE tile too large for the owners' registers steps its state
    in the load slot: both launches and both halo launches (on row-range
    views) bitwise equal to their plain versions, and to the same run on
    register-state tiles."""
    from repro_torch.kernels.spd_stream import (
        spd_multistep_halo,
        spd_multistep_halo_streamed,
    )
    from repro_torch.kernels.spd_stream.sharded import (
        spd_multistep_halo_plain,
    )

    h, w, bh, bw, m = FALLBACK_CASES[case]
    sim, f, attr, regs = _pe(h, w)
    kern = sim.stream_kernel()
    prog = kern.program
    assert prog.reg_state and not prog.owned(bh, bw, m)
    state = sim.stream_state(f, attr)
    want = spd_multistep_plain(prog, state, regs, m=m, block_h=bh,
                               block_w=bw)
    for db in (True, False):
        assert torch.equal(kern(state, regs, m=m, block_h=bh, block_w=bw,
                                double_buffer=db), want), db
    assert torch.equal(kern.multistep(state, regs, m=m, block_h=bh,
                                      block_w=bw), want)
    small = next(b for b in (32, 16) if prog.owned(bh, b, m))
    assert torch.equal(kern(state, regs, m=m, block_h=bh, block_w=small),
                       want)
    big = torch.zeros((10, h + 7, w), device="cuda")
    big[:, 3:h + 3] = state
    ext = big[:, 3:h + 3]
    hwant = spd_multistep_halo_plain(prog, ext.contiguous(), regs, m=m,
                                     block_h=bh, block_w=bw)
    for launch, kw in ((spd_multistep_halo, {}),
                       (spd_multistep_halo_streamed, {"double_buffer": True})):
        obig = torch.full((10, h - 2 * bh + 4, w), -1.0, device="cuda")
        launch(prog, ext, regs, m=m, block_h=bh, block_w=bw,
               out=obig[:, 2:h - 2 * bh + 2], **kw)
        assert torch.equal(obig[:, 2:h - 2 * bh + 2], hwant), launch
        assert (obig[:, :2] == -1).all() and (obig[:, -2:] == -1).all()


@pytest.mark.parametrize("block_h,h", [(256, 512), (300, 300)])
def test_lbm_slot_instantiation_equals_plain(card, block_h, h):
    """The hand-written kernel on tiles of more stripe cells than its
    threads own (block_h 256 and 300, m 4) steps the populations in the
    load slot, bitwise equal to its plain version."""
    from repro_torch.kernels.lbm_stream.lbm_stream import lbm_owned

    _, f, attr, regs = _pe(h, 64)
    got = lbm_multistep(f, attr, regs[0], regs[1], m=4, block_h=block_h)
    bw = 2 if block_h == 256 else 1
    assert not lbm_owned(block_h, bw, 4)
    assert torch.equal(got, lbm_multistep_plain(
        f, attr, regs[0], regs[1], m=4, block_h=block_h, block_w=bw))


@pytest.mark.parametrize("width", [98, 104])
@pytest.mark.parametrize("m", [1, 4])
def test_halo_launches_on_row_range_views(card, width, m):
    """Both halo launches read ext and write out as row ranges of larger
    buffers (plane strides in rows), on the 4-byte (width 98) and 16-byte
    (width 104) paths, bitwise equal to their plain version."""
    from repro_torch.kernels.spd_stream import (
        spd_multistep_halo,
        spd_multistep_halo_streamed,
    )
    from repro_torch.kernels.spd_stream.sharded import (
        spd_multistep_halo_plain,
    )

    sim, f, attr, regs = _pe(96, width)
    state = sim.stream_state(f, attr)
    program = sim.stream_kernel().program
    big = torch.zeros((10, 96 + 12, width), device="cuda")
    big[:, 5:101] = state
    ext = big[:, 5:101]
    want = spd_multistep_halo_plain(program, ext.contiguous(), regs, m=m,
                                    block_h=16, block_w=32)
    for launch, kw in ((spd_multistep_halo, {}),
                       (spd_multistep_halo_streamed, {"double_buffer": True}),
                       (spd_multistep_halo_streamed,
                        {"double_buffer": False})):
        obig = torch.full((10, 64 + 8, width), -1.0, device="cuda")
        got = launch(program, ext, regs, m=m, block_h=16, block_w=32,
                     out=obig[:, 3:67], **kw)
        assert got.data_ptr() == obig[:, 3:67].data_ptr()
        assert torch.equal(obig[:, 3:67], want), (launch.__name__, kw)
        assert (obig[:, :3] == -1).all() and (obig[:, 67:] == -1).all()


@pytest.mark.parametrize("m", [1, 4])
def test_halo_launches_equal_plain(card, m):
    """Guard-extended shards (96 rows: 64 + two 16-row guard blocks) of
    the uLBM PE and of diffusion, at a width with a ragged last column
    tile and at one without: both halo launches == their plain version on
    every column, streamed == declarative, double_buffer on == off."""
    from repro_torch.kernels.spd_stream import (
        spd_multistep_halo,
        spd_multistep_halo_streamed,
    )
    from repro_torch.kernels.spd_stream.sharded import (
        spd_multistep_halo_plain,
    )

    sim = lbm.LBMSimulation(lbm.LBMProblem(96, 104))
    f, attr = lbm.couette_init(96, 104)
    pe = (sim.stream_kernel().program, sim.stream_state(f, attr),
          (1 / 0.9, 0.07, 1.0))
    dsim = dif.DiffusionSimulation(96, 104)
    d = (dsim.kernel.program, dsim.state(dif.sine_init(96, 104)[0]), (0.2,))
    for program, state, regs in (pe, d):
        for width in (104, 96):
            ext = state[:, :, :width].contiguous()
            want = spd_multistep_halo_plain(program, ext, regs, m=m,
                                            block_h=16, block_w=32)
            got = spd_multistep_halo(program, ext, regs, m=m, block_h=16,
                                     block_w=32)
            assert torch.equal(got, want)
            for db in (True, False):
                assert torch.equal(spd_multistep_halo_streamed(
                    program, ext, regs, m=m, block_h=16, block_w=32,
                    double_buffer=db), want)


@pytest.mark.parametrize("case", ["tgv", "couette"])
def test_mesh_on_one_card_equals_single(card, case):
    sim = lbm.LBMSimulation(lbm.LBMProblem(64, 96))
    kern = sim.stream_kernel()
    if case == "tgv":
        f, attr, _ = lbm.taylor_green_init(64, 96)
        regs = (1 / 0.8, 0.0, 1.0)
    else:
        f, attr = lbm.couette_init(64, 96)
        regs = (1 / 0.9, 0.07, 1.0)
    state = sim.stream_state(f, attr)
    single = kern.run_blocked(state, regs, steps=8, m=4, block_h=8)
    sk = kern.sharded(4, devices=["cuda:0"] * 4, dx=2)
    assert torch.equal(sk.run_blocked(state, regs, steps=8, m=4, block_h=8),
                       single)
    assert torch.equal(sk.multistep(state, regs, m=4, block_h=8),
                       kern.run_blocked(state, regs, steps=4, m=4,
                                        block_h=8))


#: (H, W, block_h, block_w, m) of batched launches: the 16-byte path,
#: the 4-byte path (a width that is not a multiple of 4: member bases off
#: 16 bytes), a ragged last column tile, and fewer tiles a member than
#: persistent blocks (the walk crosses members).
BATCH_CASES = {
    "vec4": (64, 96, 16, 32, 4),
    "width98": (32, 98, 8, 32, 4),
    "ragged": (64, 104, 16, 32, 2),
    "few_tiles": (16, 32, 16, 32, 2),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
@pytest.mark.parametrize("app", ["diffusion", "ulbm"])
def test_batched_launches_equal_members(card, app, case):
    """A (B, P, H, W) batch runs in one launch of each periodic wrapper;
    member i is bitwise its own 3-D launch, and B 3 equals its plain
    version."""
    from repro_torch.kernels.spd_stream import (
        spd_multistep,
        spd_multistep_streamed,
    )

    h, w, bh, bw, m = BATCH_CASES[case]
    if app == "diffusion":
        sim = dif.DiffusionSimulation(h, w)
        kern, regs = sim.kernel, (0.2,)
        members = [sim.state(_noisy(dif.sine_init(h, w)[0], i))
                   for i in range(3)]
    else:
        sim, f, attr, regs = _pe(h, w)
        kern = sim.stream_kernel()
        members = [sim.stream_state(_noisy(f, i), attr) for i in range(3)]
    prog = kern.program
    for b in (1, 3):
        batch = kern.pack_batch(members[:b])
        want = spd_multistep_plain(prog, batch, regs, m=m, block_h=bh,
                                   block_w=bw)
        for fn, kw in ((spd_multistep_streamed, {"double_buffer": True}),
                       (spd_multistep_streamed, {"double_buffer": False}),
                       (spd_multistep, {})):
            n = fn.launches
            got = fn(prog, batch, regs, m=m, block_h=bh, block_w=bw, **kw)
            assert fn.launches == n + 1  # one launch for the batch
            assert torch.equal(got, want)
            for i in range(b):
                assert torch.equal(got[i], fn(prog, members[i], regs, m=m,
                                              block_h=bh, block_w=bw, **kw))


def test_batched_run_blocked_and_engine_on_the_card(card):
    """run_blocked and run_for_point over a batch equal each member's own
    run; a SimEngine on the card launches every cohort, width 1 included,
    through the kernel (a host state is moved to the card at admission)."""
    import numpy as np

    from repro_torch.kernels.spd_stream import spd_multistep_streamed
    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    sim = dif.DiffusionSimulation(64, 96)
    u0, _ = dif.sine_init(64, 96)
    members = [sim.state(_noisy(u0, i)) for i in range(3)]
    batch = sim.kernel.pack_batch(members)
    got = sim.kernel.run_blocked(batch, (0.2,), steps=8, m=4, block_h=16)
    for i, s in enumerate(members):
        assert torch.equal(got[i], sim.kernel.run_blocked(
            s, (0.2,), steps=8, m=4, block_h=16))

    # two requests from the host: one launch of width 2, then the
    # survivor alone (back from the host after the cohort dissolved)
    eng = SimEngine(PlanResolver(budget=0, b_values=(2,), bh_values=(16,),
                                 m_values=(2,)))
    n = spd_multistep_streamed.launches
    for rid, steps in ((0, 2), (1, 6)):
        eng.submit(SimRequest(rid=rid, core=sim.kernel,
                              state=members[rid].cpu().numpy(), steps=steps,
                              regs=(0.2,)))
    done = {c.rid: c for c in eng.run_until_drained()}
    assert eng.stats()["occupancy"] == {"1": 2, "2": 1}
    assert spd_multistep_streamed.launches - n == eng.launches == 3
    for rid, steps in ((0, 2), (1, 6)):
        want = sim.kernel.run_blocked(members[rid], (0.2,), steps=steps,
                                      m=2, block_h=16)
        assert isinstance(done[rid].state, np.ndarray)
        assert np.array_equal(done[rid].state, want.cpu().numpy())
    with pytest.raises(ValueError, match="given to an engine on cpu"):
        SimEngine(device="cpu").submit(SimRequest(
            rid=2, core=sim.kernel, state=members[0], steps=2,
            regs=(0.2,)))


def _engine_tenants():
    """Two contexts on the card: diffusion 64×96 at α 0.2 and the uLBM PE
    (Couette) 64×96, with four member states each."""
    sim = dif.DiffusionSimulation(64, 96)
    u0, _ = dif.sine_init(64, 96)
    pe, f, attr, pe_regs = _pe(64, 96)
    return [
        (sim.kernel, (0.2,),
         [sim.state(_noisy(u0, i)) for i in range(4)]),
        (pe.stream_kernel(), pe_regs,
         [pe.stream_state(_noisy(f, i), attr) for i in range(4)]),
    ]


def test_engine_equals_synchronized_single_launches(card):
    """A mixed stream over two contexts, host and card states, cohorts of
    two with survivors: nothing waits after a launch, and every completion
    is bitwise the same request run alone through ``kern(...)`` with a
    synchronize after each launch (steps are multiples of the plan's m, so
    every launch of a member fuses m steps)."""
    import numpy as np

    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    tenants = _engine_tenants()
    eng = SimEngine(PlanResolver(budget=0, b_values=(2,), bh_values=(16,),
                                 m_values=(4,)))
    steps = [8, 20, 12, 32, 4, 16, 24, 8]
    reqs = []
    for rid, n in enumerate(steps):
        kern, regs, states = tenants[rid % 2]
        st = states[rid // 2]
        reqs.append(SimRequest(rid=rid, core=kern, regs=regs, steps=n,
                               state=st.cpu().numpy() if rid % 4 < 2
                               else st))
        assert eng.submit(reqs[-1])
    done = {c.rid: c for c in eng.run_until_drained()}
    plans = {g.ctx.regs: g.plan for g in eng.groups.values()}
    for req in reqs:
        plan = plans[tuple(float(r) for r in req.regs)]
        assert plan.m == 4 and plan.b == 2
        x = torch.as_tensor(req.state).to("cuda")
        for _ in range(req.steps // plan.m):
            x = req.core(x, req.regs, m=plan.m, block_h=plan.block_h,
                         double_buffer=plan.double_buffer)
            torch.cuda.synchronize()
        assert np.array_equal(done[req.rid].state, x.cpu().numpy()), req.rid
    s = eng.stats()
    assert "2" in s["occupancy"] and s["launches"] > len(steps)
    assert s["waits"] > 0 and 0 < s["wait_s"] <= s["tick_s"]


def test_engine_waits_once_for_a_long_request(card):
    """One 1,024-step request at m 8: 128 launches queued on the stream
    and one wait, the dissolution's, inside ``dissolve_s``."""
    import numpy as np

    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    kern, regs, states = _engine_tenants()[0]
    eng = SimEngine(PlanResolver(budget=0, b_values=(1,), bh_values=(16,),
                                 m_values=(8,)))
    eng.submit(SimRequest(rid=0, core=kern, state=states[0], steps=1024,
                          regs=regs))
    (done,) = eng.run_until_drained()
    s = eng.stats()
    assert (s["launches"], s["waits"]) == (128, 1)
    assert 0 < s["wait_s"] <= s["dissolve_s"]
    plan = next(iter(eng.groups.values())).plan
    want = kern.run_blocked(states[0], regs, steps=1024, m=8,
                            block_h=plan.block_h,
                            double_buffer=plan.double_buffer)
    assert np.array_equal(done.state, want.cpu().numpy())


def test_engine_drains_the_card_before_a_live_timing(card, tmp_path):
    """With a tuning budget, work queued on the stream before a tick (half
    a second of ``torch.cuda._sleep``, standing in for other contexts'
    launches) has finished when the injected timer is called."""
    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    kern, regs, states = _engine_tenants()[0]
    idle = []

    def timer(plan, run, reps, warmup):
        idle.append(torch.cuda.current_stream().query())
        return 1e-3 * len(idle)

    eng = SimEngine(PlanResolver(budget=2, b_values=(1,),
                                 bh_values=(8, 16), m_values=(2, 4),
                                 study_dir=str(tmp_path), timer=timer))
    eng.submit(SimRequest(rid=0, core=kern, state=states[0], steps=16,
                          regs=regs))
    for _ in range(8):
        torch.cuda._sleep(1 << 30)
        eng.step()
        if all(g.plan is not None for g in eng.groups.values()):
            break
    assert idle and all(idle)
    assert eng.stats()["waits"] >= len(idle)
    assert len(eng.run_until_drained()) == 1


def test_launch_and_mesh_device_checks(card):
    """A halo launch writes into a row range of a larger buffer and
    refuses an output that overlaps its input; a CUDA state given to a
    mesh of CPU devices raises instead of running on the host."""
    from repro_torch.kernels.spd_stream import spd_multistep_halo_streamed

    dsim = dif.DiffusionSimulation(64, 96)
    prog, state = dsim.kernel.program, dsim.state(dif.sine_init(64, 96)[0])
    want = spd_multistep_halo_streamed(prog, state, (0.2,), m=2, block_h=8)
    buf = torch.zeros((1, 64, 96), device="cuda")
    got = spd_multistep_halo_streamed(prog, state, (0.2,), m=2, block_h=8,
                                      out=buf[:, 8:56])
    assert got.data_ptr() == buf[:, 8:56].data_ptr()
    assert torch.equal(buf[:, 8:56], want)
    with pytest.raises(ValueError, match="overlaps its input"):
        spd_multistep_halo_streamed(prog, buf, (0.2,), m=2, block_h=8,
                                    out=buf[:, 8:56])
    sk = dsim.kernel.sharded(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="mesh on cpu"):
        sk.run_blocked(state, (0.2,), steps=2, m=2, block_h=8)


def test_mesh_over_distinct_cards_equals_single(card):
    """The default device list cuda:0 … cuda:3: peer copies between
    cards and one launch per card, still bitwise the single-card run."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a mesh over distinct cards)")
    sim = lbm.LBMSimulation(lbm.LBMProblem(64, 96))
    kern = sim.stream_kernel()
    f, attr = lbm.couette_init(64, 96)
    state = sim.stream_state(f, attr)
    regs = (1 / 0.9, 0.07, 1.0)
    single = kern.run_blocked(state, regs, steps=8, m=4, block_h=4)
    for dx in (1, 2, 4):
        sk = kern.sharded(4, dx=dx)
        assert [dev for row in sk.grid for dev in row] == [
            torch.device("cuda", i) for i in range(4)]
        out = sk.run_blocked(state, regs, steps=8, m=4, block_h=4)
        assert out.device == torch.device("cuda", 0)
        assert torch.equal(out, single)


# ------------------------- flash attention, LM serving -------------------

#: The kernel against its plain version on the same CUDA inputs: f32 at
#: the JAX kernel test's 2e-3 (scalar FMAs, another summation order), bf16
#: at its 2e-2 (bf16 probabilities in P·V, bf16 output rounding).
FLASH_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}

FLASH_CASES = {
    "mha": (1, 2, 2, 128, 128, True, 0),
    "mqa": (2, 4, 1, 128, 128, True, 0),
    "gqa_prefix": (1, 4, 2, 64, 256, True, 0),
    "bidirectional": (1, 2, 2, 128, 128, False, 0),
    "window": (1, 2, 2, 256, 256, True, 64),
    "ragged": (1, 4, 2, 100, 100, True, 0),
    # the dense serving configs' groups: granite-34b's MQA 48:1,
    # nemotron-4-15b's GQA 48:8 and qwen2.5-32b's GQA 40:8
    "mqa48": (1, 48, 1, 256, 256, True, 0),
    "gqa6": (1, 48, 8, 256, 256, True, 0),
    "gqa5": (1, 40, 8, 256, 256, True, 0),
}


def _flash_inputs(case, d, dtype, seed=0):
    b, hq, hkv, sq, sk, _, _ = FLASH_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h, s: torch.randn((b, h, s, d), generator=g,  # noqa: E731
                                  device="cuda").to(dtype)
    return mk(hq, sq), mk(hkv, sk), mk(hkv, sk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_equals_plain(card, case, dtype):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    _, _, _, _, _, causal, window = FLASH_CASES[case]
    q, k, v = _flash_inputs(case, 128, dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernel_head_dims_and_strided_views(card, d):
    """Smaller head dims, and q/k/v as the transposed views the model's
    head split gives, against the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 96, 8, d), generator=g, device="cuda").to(dtype)
        kv = torch.randn((2, 96, 4, d), generator=g, device="cuda").to(dtype)
        q, k, v = x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2)
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])


def test_lm_prefill_and_engine_on_the_card(card):
    """The reduced Qwen3-8B config in f32 on the card: the prefill step
    through the kernel equals the plain-attention model, and the engine's
    greedy tokens at max_batch 2 equal the argmax of the forward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), n_layers=2,
                              head_dim=64)
    bundle = registry.build(cfg, device="cuda")
    plain = registry.build(cfg, device="cuda", use_kernel=False)
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    n = flash_attention.launches
    got = bundle.make_prefill_step()(model, {"tokens": tokens})
    assert flash_attention.launches == n + cfg.n_layers
    want = plain.make_prefill_step()(model, {"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)

    prompts = [[5, 17, 31], [7, 2, 44]]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=5))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    for rid, p in enumerate(prompts):
        seq = list(p)
        for t in done[rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor(
                [seq], device="cuda")})
            assert t == int(logits[0, -1].argmax())
            seq.append(t)


def test_flash_wgmma_descriptors(card):
    """The Hopper kernel's two products alone on one tile, through its TMA
    loads and wgmma descriptors: s = a k^T (both K-major) and o = bf16(s) v
    (A from registers, V MN-major), against torch.matmul in f32. The
    products of bf16 values are exact in f32; only the summation order
    differs (rtol 1e-4, atol 1e-3 at magnitudes of ~10)."""
    from repro_torch.kernels.build import check, load_flash_library

    lib = load_flash_library()
    g = torch.Generator(device="cuda").manual_seed(3)
    for d in (64, 112, 128):
        a, k, v = (torch.randn((r, d), generator=g, device="cuda").to(
            torch.bfloat16) for r in (64, 128, 128))
        s = torch.empty((64, 128), device="cuda")
        o = torch.empty((64, d), device="cuda")
        check(lib.flash_wgmma_probe(
            a.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), d, torch.cuda.current_stream().cuda_stream),
            "flash_wgmma_probe")
        torch.cuda.synchronize()
        torch.testing.assert_close(s, a.float() @ k.float().T, rtol=1e-4,
                                   atol=1e-3)
        torch.testing.assert_close(o, s.bfloat16().float() @ v.float(),
                                   rtol=1e-4, atol=1e-3)


#: (B, Hq, Hkv, Sq, Sk, causal, window, block_q, block_k): a window that
#: ends mid-tile with ragged tiles; a ragged 192-row query tile against a
#: ragged 320-key KV (diagonal offset Sk - Sq = 128); and a diagonal
#: offset of 133, off every tile edge.
FLASH_EDGE_CASES = {
    "window300": (1, 2, 2, 300, 300, True, 100, 100, 100),
    "offset192x320": (1, 4, 2, 192, 320, True, 0, 64, 64),
    "offset200x333": (1, 4, 2, 200, 333, True, 0, 100, 111),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_EDGE_CASES))
def test_flash_kernel_tile_edges(card, case, dtype):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    b, hq, hkv, sq, sk, causal, window, bq, bk = FLASH_EDGE_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((b, hq, sq, 128), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, sk, 128), generator=g, device="cuda").to(
        dtype) for _ in range(2))
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
    want = flash_attention_plain(q, k, v, block_k=bk, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("d", [32, 64])
def test_flash_bf16_head_dims_on_split_views(card, d, window):
    """bf16 at D 32 (the simple kernel) and D 64 (the Hopper kernel) on
    the transposed views of the model's head split, over several ragged
    tiles."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 300, 8 * d), generator=g, device="cuda").bfloat16()
    kx, vx = (torch.randn((2, 300, 2 * d), generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    q = x.view(2, 300, 8, d).transpose(1, 2)
    k = kx.view(2, 300, 2, d).transpose(1, 2)
    v = vx.view(2, 300, 2, d).transpose(1, 2)
    kw = dict(causal=True, window=window, block_q=100, block_k=100)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


def test_flash_qwen3_launch_at_prefill_strides(card):
    """The Qwen3-8B prefill launch (q 4x32x2048x128, kv 4x8x2048x128, bf16,
    causal) on the head-split views the prefill passes, read in place."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _kernel_operand,
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((4, 2048, 32 * 128), generator=g, device="cuda")
    kx, vx = (torch.randn((4, 2048, 8 * 128), generator=g, device="cuda")
              for _ in range(2))
    q = q.bfloat16().view(4, 2048, 32, 128).transpose(1, 2)
    k = kx.bfloat16().view(4, 2048, 8, 128).transpose(1, 2)
    v = vx.bfloat16().view(4, 2048, 8, 128).transpose(1, 2)
    assert all(_kernel_operand(x) is x for x in (q, k, v))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_head_dim_112_equals_plain(card, case, dtype):
    """D 112 (Zamba2's shared attention): bf16 through the Hopper
    kernel's padded instantiation, f32 through the simple kernel; the 128
    query rows of 64x64 and 128x128 blocks give the same bits."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    _, _, _, _, _, causal, window = FLASH_CASES[case]
    q, k, v = _flash_inputs(case, 112, dtype, seed=7)
    kw = dict(causal=causal, window=window)
    got = flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if q.shape[2] % 64 == 0 and k.shape[2] % 64 == 0:
        small = flash_attention(q, k, v, block_q=64, block_k=64, **kw)
        assert torch.equal(small, got)


def test_flash_zamba2_launch_at_prefill_strides(card):
    """The Zamba2-7B shared block's prefill launch (q = kv 4x32x2048x112,
    bf16, causal) on the head-split views the prefill passes: strides of
    224 B (head), 7,168 B (sequence), read in place."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _kernel_operand,
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((4, 2048, 32 * 112), generator=g, device="cuda")
               .bfloat16().view(4, 2048, 32, 112).transpose(1, 2)
               for _ in range(3))
    assert q.stride()[1:3] == (112, 32 * 112)
    assert all(_kernel_operand(x) is x for x in (q, k, v))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_prefill_and_engine_on_the_card(card, dtype):
    """A narrow Zamba2 at D 112 (d_model 448, 4 heads; two groups and a
    tail layer) on the card: the prefill through the kernel (one launch
    per site of the shared block) equals the plain-attention twin, and
    in f32 the engine's greedy tokens at max_batch 2, with a re-used
    slot, equal the argmax of the forward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), d_model=448,
                              n_heads=4, n_kv_heads=4, head_dim=112,
                              n_layers=5, dtype=dtype)
    bundle = registry.build(cfg, device="cuda")
    plain = registry.build(cfg, device="cuda", use_kernel=False)
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    n = flash_attention.launches
    got = bundle.make_prefill_step()(model, {"tokens": tokens})
    assert flash_attention.launches == n + 2
    want = plain.make_prefill_step()(model, {"tokens": tokens})
    tol = (dict(rtol=2e-3, atol=2e-3) if dtype == "float32"
           else dict(rtol=5e-2, atol=5e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype != "float32":
        return
    prompts = [[5, 17, 31], [7, 2, 44], [9, 3]]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=5))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    for rid, p in enumerate(prompts):
        seq = list(p)
        for t in done[rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor(
                [seq], device="cuda")})
            assert t == int(logits[0, -1].argmax())
            seq.append(t)


def test_flash_launch_faults_raise(card):
    """No fallback on the bf16 path: a head dim the library does not
    instantiate, a pair of head dims it does not (v at 192 beside q and k
    at 192), and a TMA descriptor that cuTensorMapEncodeTiled refuses (a
    base off 16-byte alignment) raise from the C entry point."""
    from repro_torch.kernels.build import (
        FlashStrides,
        check,
        load_flash_library,
    )

    lib = load_flash_library()
    x = torch.zeros((1, 1, 256, 128), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call(ptr, d, dv=None):
        st = FlashStrides()
        for i in range(4):
            st.s[3 * i:3 * i + 3] = [256 * d, 256 * d, d]
        return lib.flash_attention_fwd(ptr, ptr, ptr, out.data_ptr(), 1, 1,
                                       1, 1, 128, 128, d, dv or d, st, 0.1,
                                       1, 0, None, 0, 0, None, stream)

    with pytest.raises(RuntimeError, match="no instantiation"):
        check(call(x.data_ptr(), 96), "flash_attention")
    with pytest.raises(RuntimeError, match="no instantiation"):
        check(call(x.data_ptr(), 192), "flash_attention")
    with pytest.raises(RuntimeError, match="TMA descriptor"):
        check(call(x.data_ptr() + 2, 128), "flash_attention")


# ---- the model -> measure -> search loop (chip_smoke.py phase 7) -------


@pytest.mark.parametrize("app", ["lbm", "diffusion"])
def test_dse_search_on_the_card(card, app, tmp_path):
    """A calibrated frontier search through the generated kernel on the
    card: every executed point feasible and run on the card, the best
    plan's output within rtol 2e-5 / atol 1e-6 of the reference, and a
    repeat served from the cache."""
    from repro_torch.core.dse import GPUModel
    from repro_torch.core.search import ExhaustiveSearch

    if app == "lbm":
        sim = lbm.LBMSimulation(lbm.LBMProblem(256, 256))
        f, attr, _ = lbm.taylor_green_init(256, 256)
        kern, state, regs = (sim.stream_kernel(), sim.stream_state(f, attr),
                             sim.stream_regs())
    else:
        sim = dif.DiffusionSimulation(512, 512)
        kern, state, regs = (sim.kernel, sim.state(dif.sine_init(512, 512)[0]),
                             (0.2,))
    ex = sim.explorer()
    sweep = ex.sweep_gpu(bh_values=(8, 16, 32), m_values=(1, 2, 4),
                         d_values=(1,))
    kw = dict(strategy=ExhaustiveSearch(k=2, frontier_only=True),
              cache=str(tmp_path / "c.json"))
    res = ex.search(sweep, state, regs, **kw)
    assert res.executed and res.budget_spent > 0
    for e in res.executed:
        assert not e.interpret and e.calibrated_gflops > 0
        assert GPUModel().evaluate(ex.workload, e.block_h, e.m).feasible
    best = res.best
    out = kern.run_blocked(state, regs, steps=best.steps, m=best.m,
                           block_h=best.block_h,
                           double_buffer=best.double_buffer)
    torch.testing.assert_close(out, kern.reference(state, regs,
                                                   m=best.steps),
                               rtol=2e-5, atol=1e-6)
    assert ex.search(sweep, state, regs, **kw).budget_spent == 0


def test_tpe_study_resume_on_the_card(card, tmp_path):
    """A seeded TPE study and its resume: nothing re-measured, the same
    trial sequence."""
    from repro_torch.core.search import Study, TPESearch

    sim = lbm.LBMSimulation(lbm.LBMProblem(256, 256))
    f, attr, _ = lbm.taylor_green_init(256, 256)
    ex = sim.explorer()
    sweep = ex.sweep_gpu(bh_values=(8, 16, 32), m_values=(1, 2, 4),
                         d_values=(1,))
    runs = []
    for _ in range(2):
        res = ex.search(sweep, sim.stream_state(f, attr), sim.stream_regs(),
                        strategy=TPESearch(seed=0, max_trials=4), budget=4,
                        calibrate=False, cache=False, study="s",
                        study_dir=str(tmp_path))
        journal = [(r["point"]["block_h"], r["point"]["m"])
                   for r in Study.resume("s", str(tmp_path)).records]
        runs.append((res.budget_spent, res.replayed, journal))
    assert runs[0][:2] == (4, 0) and runs[1][:2] == (0, 4)
    assert runs[0][2] == runs[1][2]


def test_fma_chain_kernel_equals_plain(card):
    """The calibration probe's 32-deep FMA core (halo 0, one plane, one
    register) on the card, bitwise against its plain version."""
    from repro_torch.core.measure import fma_chain_kernel

    kern = fma_chain_kernel(32)
    g = torch.Generator(device="cuda").manual_seed(8)
    st = torch.rand((1, 512, 640), generator=g, device="cuda")
    for m in (1, 3):
        bw = kern.tile(640, 32, m)[0]
        want = spd_multistep_plain(kern.program, st, (0.997,), m=m,
                                   block_h=32, block_w=bw)
        assert torch.equal(kern(st, (0.997,), m=m, block_h=32), want)
        assert torch.equal(kern(st, (0.997,), m=m, block_h=32,
                                double_buffer=False), want)


# ---- stream programs (chip_smoke.py phase 8, docs/port.md §program) ----


def _program_app(app: str, h: int, w: int):
    """(program, monolithic kernel, state, regs, block_h) of one app."""
    from repro_torch.apps import advection_diffusion as ad

    if app == "lbm":
        sim = lbm.LBMSimulation(lbm.LBMProblem(h, w, u_lid=0.07))
        f, attr = lbm.couette_init(h, w)
        return (sim.program(), sim.stream_kernel(),
                sim.stream_state(f, attr), sim.stream_regs(), 16)
    sim = ad.AdvectionDiffusionSimulation(h, w)
    return (sim.program, sim.monolithic_core.stream_kernel(),
            sim.state(ad.blob_init(h, w)), sim.regs(), 32)


@pytest.mark.parametrize("app", ["lbm", "advdiff"])
@pytest.mark.parametrize("m", [1, 4])
def test_program_partitions_equal_monolith(card, app, m):
    """Every partition on the card — fused clusters, pipelined chains of
    halo-0 and stencil clusters — bitwise equal to the monolithic kernel
    at the same plan."""
    from repro_torch.core.program import fusion_partitions

    prog, mono, state, regs, bh = _program_app(app, 512, 1024)
    want = mono.run_blocked(state, regs, steps=8, m=m, block_h=bh)
    for spec in fusion_partitions(prog.nstages):
        got = prog.kernel(spec).run_blocked(state, regs, steps=8, m=m,
                                            block_h=bh)
        assert torch.equal(got, want), spec


@pytest.mark.parametrize("app", ["lbm", "advdiff"])
def test_pipelined_graph_equals_eager_chain(card, app):
    """The replayed CUDA graph of one program step equals the same chain
    of cluster launches run eagerly, and counts one launch per cluster
    per replayed step."""
    from repro_torch.core.program import fusion_partitions
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_streamed,
    )

    prog, _, state, regs, bh = _program_app(app, 256, 512)
    spec = fusion_partitions(prog.nstages)[-1]  # fully pipelined
    pk = prog.kernel(spec)
    eager = state
    for _ in range(3):
        for kern, (a, b) in zip(pk.clusters, pk.spans):
            eager = kern(eager, regs[prog.reg_slice(a, b)], m=1, block_h=bh)
    pk.run_blocked(state, regs, steps=1, m=1, block_h=bh)  # capture
    before = spd_multistep_streamed.launches
    got = pk.run_blocked(state, regs, steps=3, m=1, block_h=bh)
    assert torch.equal(got, eager)
    assert spd_multistep_streamed.launches - before == 3 * len(pk.clusters)


def test_pipelined_graphs_share_one_ring(card):
    """The graphs of every pipelined partition and plan run on the
    program's one ring for the shape: three state buffers for the 3-core
    uLBM program, however many graphs are captured."""
    prog, _, state, regs, bh = _program_app("lbm", 256, 512)
    specs = ("2+1", "1+2", "1+1+1")
    want = prog.kernel("3").run_blocked(state, regs, steps=2, m=1,
                                        block_h=bh)
    for spec in specs:
        for b in (8, bh):
            got = prog.kernel(spec).run_blocked(state, regs, steps=2, m=1,
                                                block_h=b)
            assert torch.equal(got, want), (spec, b)
    ptrs = {t.data_ptr() for t in prog.ring(state, 3)}
    graphs = [g for spec in specs
              for g in prog.kernel(spec)._graphs.values()]
    assert len(graphs) == 6 and len(prog._rings) == 1 and len(ptrs) == 3
    assert all({t.data_ptr() for t in g.bufs} <= ptrs for g in graphs)


def test_pipelined_run_makes_no_host_sync(card):
    """A pipelined run (after its capture) under
    ``torch.cuda.set_sync_debug_mode("error")``: no call synchronizes the
    host with the card — the counterpart of the reference's transfer
    guard. ``run_unfused`` synchronizes and is refused."""
    prog, _, state, regs, bh = _program_app("lbm", 256, 512)
    pk = prog.kernel("1+1+1")
    want = pk.run_blocked(state, regs, steps=2, m=1, block_h=bh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pk.run_blocked(state, regs, steps=2, m=1, block_h=bh)
        with pytest.raises(RuntimeError):
            pk.run_unfused(state, regs, steps=1, block_h=bh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


# ------------------------- MoE, GQA at D 112, binding windows -------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["gqa8_d112", "window256_d128"])
def test_flash_gqa_d112_and_binding_window_equal_plain(card, shape, dtype):
    """Kimi K2's attention, D 112 with 8 query heads per KV head, and a
    window that skips key tiles (Sk 1024, window 256, Mixtral's D 128 and
    GQA 4), each against the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    b, hq, hkv, s, d, window = {"gqa8_d112": (2, 16, 2, 384, 112, 0),
                                "window256_d128": (1, 8, 2, 1024, 128, 256)
                                }[shape]
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, hq, s, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    got = flash_attention(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_kimi_launch_at_prefill_strides(card):
    """The Kimi K2 prefill launch (q 4x64x2048x112, kv 4x8x2048x112, bf16,
    causal) on the head-split views the prefill passes, read in place."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _kernel_operand,
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn((4, 2048, 64 * 112), generator=g, device="cuda")
    kx, vx = (torch.randn((4, 2048, 8 * 112), generator=g, device="cuda")
              for _ in range(2))
    q = q.bfloat16().view(4, 2048, 64, 112).transpose(1, 2)
    k = kx.bfloat16().view(4, 2048, 8, 112).transpose(1, 2)
    v = vx.bfloat16().view(4, 2048, 8, 112).transpose(1, 2)
    assert all(_kernel_operand(x) is x for x in (q, k, v))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


def _moe_cfg(name, cf=None, **changes):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(name).reduced(), **changes)
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


@pytest.mark.parametrize("cf", [None, 0.75])
@pytest.mark.parametrize("name", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_apply_on_the_card_equals_its_cpu_twin(card, name, cf):
    """The MoE block on the card against the same weights and tokens on
    the CPU, f32 (cuBLAS against the CPU's products: rtol/atol 1e-5); the
    same assignments kept, drops included at capacity factor 0.75."""
    from repro_torch.models import layers as tl

    cfg = _moe_cfg(name, cf)
    moe = tl.MoE(cfg, device="cpu")
    moe.init_weights(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = tl.moe_apply(moe, x, cfg)
    keep = tl.moe_route(moe, x.reshape(-1, cfg.d_model), cfg)[3]
    moe.to("cuda")
    got = tl.moe_apply(moe, x.cuda(), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    got_keep = tl.moe_route(moe, x.cuda().reshape(-1, cfg.d_model), cfg)[3]
    assert torch.equal(got_keep.cpu(), keep)
    assert keep.all() == (cf is None)


def test_moe_prefill_and_engine_on_the_card(card):
    """A narrow Mixtral (2 MoE layers, window 16, f32) on the card: the
    prefill through the kernel equals the plain-attention twin, and with
    the no-drop capacity E/k the engine's greedy tokens at max_batch 2,
    with a re-used slot, equal the argmax of the forward."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = _moe_cfg("mixtral-8x7b", cf=2.0, head_dim=64)
    bundle = registry.build(cfg, device="cuda")
    plain = registry.build(cfg, device="cuda", use_kernel=False)
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    n = flash_attention.launches
    got = bundle.make_prefill_step()(model, {"tokens": tokens})
    assert flash_attention.launches == n + cfg.n_layers
    want = plain.make_prefill_step()(model, {"tokens": tokens})
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    prompts = [[5, 17, 31], [7, 2, 44], [9, 3]]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=5))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    for rid, p in enumerate(prompts):
        seq = list(p)
        for t in done[rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor(
                [seq], device="cuda")})
            assert t == int(logits[0, -1].argmax())
            seq.append(t)


def test_async_checkpoint_snapshots_cuda_tensors(card, tmp_path):
    """``AsyncCheckpointer.save`` copies CUDA leaves to the host before
    its thread starts: launches issued right after it overwrite the
    tensors in place, and the checkpoint holds the values at the call;
    a restore lands on the ``like`` leaves' card, in their dtype."""
    from repro_torch.train import checkpoint as ckpt

    g = torch.Generator(device="cuda").manual_seed(11)
    f = torch.randn((9, 512, 512), generator=g, device="cuda")
    b16 = torch.randn(1000, generator=g, device="cuda").bfloat16()
    want = (f.cpu(), b16.cpu())
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(1, {"f": f, "b16": b16})
    for _ in range(20):
        f.mul_(1.5).add_(1.0)
    b16.zero_()
    saver.wait()
    _, tree, _ = ckpt.restore_latest(str(tmp_path), {"f": f, "b16": b16})
    assert tree["f"].is_cuda and tree["b16"].dtype == torch.bfloat16
    assert torch.equal(tree["f"].cpu(), want[0])
    assert torch.equal(tree["b16"].cpu(), want[1])


# ------------- the encoder-decoder path at D 64, GQA 7 (VLM) -------------

#: (B, Hq, Hkv, Sq, Sk, causal) at whisper-medium's D 64, cut to fewer
#: clips: the encoder's self-attention over a ragged 1500 frames, the
#: cross-attention (Sq = Sk / 4, non-causal), the decoder's causal
#: self-attention at a ragged 375, and the decode step's cross-attention
#: (Sq 1); at D 128, LLaVA-NeXT-34B's GQA 56:8 at a small S.
ENCDEC_FLASH_CASES = {
    "enc1500_d64": (1, 16, 16, 1500, 1500, False, 64),
    "cross375x1500_d64": (2, 16, 16, 375, 1500, False, 64),
    "dec375_d64": (2, 16, 16, 375, 375, True, 64),
    "decode1x1500_d64": (8, 16, 16, 1, 1500, False, 64),
    "gqa7_d128": (1, 56, 8, 384, 384, True, 128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ENCDEC_FLASH_CASES))
def test_flash_encdec_and_gqa7_shapes_equal_plain(card, case, dtype):
    """Each shape through the dispatcher (``ops.attention`` on a CUDA
    tensor: one kernel launch, whatever the length), q as the head-split
    view the model passes, against the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import attention

    b, hq, hkv, sq, sk, causal, d = ENCDEC_FLASH_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(12)
    q = (torch.randn((b, sq, hq * d), generator=g, device="cuda").to(dtype)
         .view(b, sq, hq, d).transpose(1, 2))
    k, v = (torch.randn((b, hkv, sk, d), generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    n = flash_attention.launches
    got = attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_and_decode_on_the_card(card, dtype):
    """A narrow whisper-medium (d_model 256, 4 heads at D 64, 2 + 2
    layers) on the card: the encoder-decoder forward through the kernel
    (three launches per layer pair) equals the plain-attention twin on
    ragged lengths (120 frames, 30 tokens), and in f32 the primed decode
    steps (one launch per layer at Sq 1) equal the forward's rows."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_arch("whisper-medium").reduced(),
                              d_model=256, n_heads=4, n_kv_heads=4,
                              head_dim=64, n_layers=2, dtype=dtype)
    bundle = registry.build(cfg, device="cuda")
    plain = registry.build(cfg, device="cuda", use_kernel=False)
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("t", 120, 2, "prefill"),
                                seed=1, device="cuda")
    n = flash_attention.launches
    got = bundle.forward(model, batch)
    assert flash_attention.launches == n + 3 * cfg.n_layers
    want = plain.forward(model, batch)
    tol = (dict(rtol=2e-3, atol=2e-3) if dtype == "float32"
           else dict(rtol=5e-2, atol=5e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype != "float32":
        return
    tokens = batch["tokens"]
    enc = tfm.encode(model, batch["frames"])
    cache = tfm.prime_cross_cache(model, bundle.cache_init(2, 30), enc)
    n = flash_attention.launches
    for t in range(tokens.shape[1]):
        lg, cache = bundle.decode(model, tokens[:, t:t + 1], cache, t)
        torch.testing.assert_close(lg[:, 0], got[:, t], rtol=2e-3,
                                   atol=2e-3)
    assert flash_attention.launches == n + cfg.n_layers * tokens.shape[1]


# ---- flash attention with a gradient (docs/port.md §train) -------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 4, 256, 0), (2, 8, 2, 384, 128)])
def test_flash_function_gradient_equals_the_plain_path(card, dtype, shape):
    """On CUDA inputs that require grad the dispatcher runs the kernel
    inside ``FlashAttentionFn``: its forward is one launch of the kernel;
    its backward is one launch of the backward kernel in bf16 (the Hopper
    path) and none in f32 (the recompute); the gradients of q, k and v
    equal autograd through the chunked plain version (f32 bitwise-close at
    1e-5, bf16 at the kernel's 2e-2 on the forward and the backward's own
    rounding)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ops import (
        attention,
        attention_chunked_ref,
    )

    b, hq, hkv, s, window = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, h, s, 64), generator=g, device="cuda").to(
        dt).requires_grad_(True) for h in (hq, hkv, hkv))
    go = torch.randn((b, hq, s, 64), generator=g, device="cuda").to(dt)
    n, nb = flash_attention.launches, flash_attention_bwd.launches
    out = attention(q, k, v, window=window)
    assert flash_attention.launches == n + 1
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), go)
    assert flash_attention.launches == n + 1
    assert flash_attention_bwd.launches == nb + (dtype == "bfloat16")
    ref = attention_chunked_ref(q, k, v, window=window, chunk=s)
    want = torch.autograd.grad(ref, (q, k, v), go)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(out.float(), ref.float(), **(
        dict(rtol=2e-3, atol=2e-3) if dtype == "float32" else tol))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Sk, D, causal): Zamba2's D 112 MHA, whisper's
    # encoder (ragged, non-causal) and cross-attention (Sq != Sk), and
    # LLaVA's GQA 7
    (2, 4, 4, 256, 256, 112, True), (2, 4, 4, 300, 300, 64, False),
    (2, 4, 4, 75, 300, 64, False), (1, 14, 2, 256, 256, 128, True)])
def test_flash_function_training_shapes_equal_the_plain_path(card, dtype,
                                                             shape):
    """``FlashAttentionFn`` through the dispatcher at the training paths'
    launch shapes (phase 11d): one kernel launch forward, one backward
    launch in bf16 and none in f32, the output and the gradients of q, k
    and v against autograd through the chunked plain version over all the
    keys (tolerances as
    test_flash_function_gradient_equals_the_plain_path)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ops import (
        attention,
        attention_chunked_ref,
    )

    b, hq, hkv, sq, sk, d, causal = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda").to(
        dt).requires_grad_(True) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    go = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dt)
    n, nb = flash_attention.launches, flash_attention_bwd.launches
    out = attention(q, k, v, causal=causal)
    assert flash_attention.launches == n + 1
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), go)
    assert flash_attention.launches == n + 1
    assert flash_attention_bwd.launches == nb + (dtype == "bfloat16")
    ref = attention_chunked_ref(q, k, v, causal=causal, chunk=sk)
    want = torch.autograd.grad(ref, (q, k, v), go)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(out.float(), ref.float(), **(
        dict(rtol=2e-3, atol=2e-3) if dtype == "float32" else tol))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **tol)


def _train_cell_inputs(seed):
    """The train cell's launch shape (Mixtral-8x7B, B 2, 32 query and 8 KV
    heads, S 2048, D 128), bf16, and an output gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda h: torch.randn((2, h, 2048, 128), generator=g,  # noqa: E731
                               device="cuda").bfloat16()
    return mk(32), mk(8), mk(8), mk(32)


def test_flash_backward_at_the_train_cell_shape_equals_the_plain_path(card):
    """The train cell's attention (causal, window 4096) through
    ``FlashAttentionFn``: one backward launch, dq, dk and dv within the
    bf16 tolerance of autograd through the chunked plain version at the
    model path's chunk."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ops import (
        attention,
        attention_chunked_ref,
    )

    q, k, v, go = _train_cell_inputs(7)
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    nb = flash_attention_bwd.launches
    got = torch.autograd.grad(attention(*xs, window=4096), xs, go)
    assert flash_attention_bwd.launches == nb + 1
    ref = attention_chunked_ref(*xs, window=4096, chunk=512)
    want = torch.autograd.grad(ref, xs, go)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Sk, D, causal, window)
    (2, 32, 8, 2048, 2048, 128, True, 4096), (2, 4, 4, 300, 300, 64, False, 0),
    (2, 4, 4, 75, 300, 64, False, 0), (2, 4, 4, 256, 256, 112, True, 0)])
def test_flash_backward_is_deterministic(card, shape):
    """Two launches on the same inputs give the same bits of dq, dk and dv
    (each element is summed by one block in a fixed order), within the bf16
    tolerance of the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    b, hq, hkv, sq, sk, d, causal, window = shape
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, go = (torch.randn((b, h, s, d), generator=g,
                               device="cuda").bfloat16()
                   for h, s in ((hq, sq), (hkv, sk), (hkv, sk), (hq, sq)))
    kw = dict(causal=causal, window=window)
    _, lse, o = flash_attention(q, k, v, **kw, block_q=sq, block_k=sk,
                                for_backward=True)
    first = flash_attention_bwd(q, k, v, o, lse, go, **kw)
    second = flash_attention_bwd(q, k, v, o, lse, go, **kw)
    for a, w in zip(first, second):
        assert torch.equal(a, w)
    # and the plain version on the card's own o and lse
    want = flash_attention_bwd_plain(q, k, v, o, lse, go, **kw)
    for a, w in zip(first, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Sk, D, causal, window)
    (2, 32, 8, 2048, 2048, 128, True, 4096), (1, 4, 2, 64, 256, 128, True, 0),
    (2, 4, 4, 300, 300, 64, False, 0), (1, 4, 1, 100, 100, 112, True, 32)])
def test_flash_forward_lse_equals_logsumexp(card, shape):
    """The Hopper forward's log-sum-exp equals ``torch.logsumexp`` of the
    masked scaled logits, its f32 output rounds to its output, and a
    forward asked for neither gives the same output bits; off the Hopper
    path (f32, D 32) asking for them raises."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    b, hq, hkv, sq, sk, d, causal, window = shape
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda").bfloat16()
               for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    kw = dict(causal=causal, window=window, block_q=sq, block_k=sk)
    out, lse, out32 = flash_attention(q, k, v, **kw, for_backward=True)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    want = attention_lse_ref(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    # the f32 output is the one rounded into out
    assert out32.dtype == torch.float32 and torch.equal(out32.to(out.dtype),
                                                        out)
    for x, dd in ((q.float(), d), (q[..., :32], 32)):
        with pytest.raises(ValueError, match="log-sum-exp"):
            flash_attention(x, k[..., :dd].to(x.dtype), v[..., :dd].to(
                x.dtype), **kw, for_backward=True)


def test_flash_kernel_with_grad_raises(card):
    """A direct kernel call on inputs that require grad raises rather than
    return an output with no gradient; under ``no_grad`` it launches."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )

    q = torch.randn((1, 2, 128, 64), device="cuda").requires_grad_(True)
    k = torch.randn((1, 2, 128, 64), device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape


@pytest.mark.parametrize("shape,fsdp", [((2, 4), None), ((4, 2), ("data",))])
def test_moe_all_to_all_on_the_card_equals_the_two_stage_dispatch(
        card, shape, fsdp):
    """The expert-parallel dispatch on the logical mesh ``["cuda:0"] *
    8`` against the two-stage dispatch at ``dp_size`` 8 on the card, f32:
    the same drops per rank and block, the outputs within the f32
    tolerance of the CPU tests; the all-to-all bytes are copied on the
    card."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as tl
    from repro_torch.parallel.hints import sharding_hints
    from repro_torch.parallel.moe_ep import moe_ep_apply

    cfg = _moe_cfg("mixtral-8x7b", cf=1.0)
    moe = tl.MoE(cfg, device="cuda")
    moe.init_weights(cfg, torch.Generator(device="cuda").manual_seed(1))
    x = torch.randn((4, 16, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    mesh = make_mesh(shape, ("data", "model"), ["cuda:0"] * 8)
    with sharding_hints(ep="model", ep_size=shape[1], dp=("data",),
                        dp_size=shape[0], a2a=mesh, fsdp=fsdp):
        got = tl.moe_apply(moe, x, cfg)
    stats = moe_ep_apply.last
    with sharding_hints(dp_size=8):
        want = tl.moe_apply(moe, x, cfg)
        keep = tl.moe_route(moe, x.reshape(64, -1), cfg, 8)[3]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    assert torch.equal(stats["dropped"], (~keep).view(8, -1).sum(1))
    assert stats["a2a_bytes"][0] == 8 * 4 * stats["cap"] * cfg.d_model * 4


def test_pipelined_layers_on_the_card_are_bitwise_the_sequential_ones(card):
    """A narrow Qwen3 stack (4 layers, bf16, the flash kernel at D 128) in
    2 stages over ``["cuda:0"] * 2``, 3 microbatches: bitwise the layers
    run one microbatch at a time, with one launch per layer and
    microbatch."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.parallel.pipeline import (
        pipelined_forward,
        stack_stage_params,
    )

    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), n_layers=4,
                              head_dim=128, dtype="bfloat16")
    model = tt.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    micro = torch.randn((3, 1, 256, cfg.d_model), device="cuda").bfloat16()
    pos = torch.arange(256, device="cuda")[None]

    def stage_fn(layers, x):
        for layer in layers:
            x = layer(x, cfg, pos)
        return x

    run = pipelined_forward(make_mesh((2,), ("stage",), ["cuda:0"] * 2),
                            stage_fn)
    with torch.no_grad():
        want = torch.stack([stage_fn(model.layers, x) for x in micro])
        n0 = flash_attention.launches
        got = run(stack_stage_params(model.layers, 2), micro)
    assert flash_attention.launches - n0 == 12
    assert torch.equal(got, want)


# ----------------------------- fused AdamW -----------------------------

ADAMW_DTYPES = [torch.float32, torch.bfloat16]


def _adamw_part(n, p, g, s, *, seed=0, offset=0, decay=True, name="x"):
    """A part of ``n`` elements on the card with a mid-training state:
    moments of a few steps, some elements still at zero. ``offset``
    elements in, each tensor is a view whose pointer is not 16-byte
    aligned."""
    from repro_torch.kernels.adamw.adamw import AdamWPart

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(dt, fn):
        x = fn(gen).to(dt)
        return torch.cat([torch.zeros(offset, dtype=dt, device="cuda"),
                          x])[offset:]

    def randn(k):
        return torch.randn(n, device="cuda", generator=k)

    m = draw(s, lambda k: randn(k) * 1e-2)
    v = draw(s, lambda k: torch.rand(n, device="cuda", generator=k) * 1e-4)
    m[::7] = 0
    v[::7] = 0
    return AdamWPart(name, draw(p, randn), draw(g, lambda k: randn(k) * 3),
                     m, v, decay)


def _adamw_scalars(scale=0.37, step=3):
    from repro_torch.train.optimizer import AdamWConfig, lr_at

    cfg = AdamWConfig(warmup_steps=2, total_steps=50)
    t = torch.tensor(step, dtype=torch.float32, device="cuda")
    return cfg, (lr_at(cfg, t - 1),
                 torch.tensor(scale, dtype=torch.float32, device="cuda"),
                 1 - cfg.b1 ** t, 1 - cfg.b2 ** t)


def _plain_then_kernel(parts, cfg, scalars):
    """``_update`` on clones of ``parts``, the kernel on ``parts``; both
    states after."""
    from repro_torch.kernels.adamw.adamw import adamw_step
    from repro_torch.train.optimizer import _update

    clones = [pt._replace(p=pt.p.clone(), m=pt.m.clone(), v=pt.v.clone())
              for pt in parts]
    for pt in clones:
        _update(cfg, pt.p, pt.g, pt.m, pt.v, *scalars, pt.decay)
    adamw_step(parts, *scalars, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
               weight_decay=cfg.weight_decay)
    return clones


def _assert_states_equal(got, want):
    for a, b in zip(got, want):
        for role in ("p", "m", "v"):
            x, y = getattr(a, role), getattr(b, role)
            assert x.dtype == y.dtype
            assert torch.equal(x, y), f"{a.name}: {role} differs"


@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("s", ADAMW_DTYPES)
@pytest.mark.parametrize("g", ADAMW_DTYPES)
@pytest.mark.parametrize("p", ADAMW_DTYPES)
def test_adamw_step_equals_plain_update(card, p, g, s, decay):
    """Every dtype case the kernel takes, with and without decay, over a
    length that is no multiple of the vector width (three whole tiles and
    a ragged tail): ``p``, ``m`` and ``v`` bitwise ``_update``'s."""
    from repro_torch.kernels.adamw.adamw import TILE, adamw_step

    cfg, scalars = _adamw_scalars()
    parts = [_adamw_part(3 * TILE + 13, p, g, s, decay=decay),
             _adamw_part(5, p, g, s, seed=1, decay=decay)]
    n0 = adamw_step.launches
    want = _plain_then_kernel(parts, cfg, scalars)
    torch.cuda.synchronize()
    assert adamw_step.launches == n0 + 1
    _assert_states_equal(parts, want)


@pytest.mark.parametrize("s", ADAMW_DTYPES)
@pytest.mark.parametrize("p", ADAMW_DTYPES)
def test_adamw_step_on_unaligned_views_equals_plain(card, p, s):
    """Views one element in (pointers not 16-byte aligned) take the
    scalar path, beside an aligned part: bitwise ``_update``'s."""
    cfg, scalars = _adamw_scalars(scale=1.0, step=1)
    parts = [_adamw_part(2 * 4096 + 3, p, torch.bfloat16, s, offset=1),
             _adamw_part(777, p, torch.float32, s, seed=2, offset=3),
             _adamw_part(4096, p, torch.bfloat16, s, seed=3)]
    assert parts[0].p.data_ptr() % 16 and parts[1].m.data_ptr() % 16
    want = _plain_then_kernel(parts, cfg, scalars)
    torch.cuda.synchronize()
    _assert_states_equal(parts, want)


def test_adamw_step_chunks_a_long_part_table(card):
    """More parts than one launch's table: one launch a table, every part
    bitwise ``_update``'s."""
    from repro_torch.kernels.adamw.adamw import MAX_PARTS, adamw_step

    cfg, scalars = _adamw_scalars()
    n = 2 * MAX_PARTS + 5
    parts = [_adamw_part(1 + 97 * i, ADAMW_DTYPES[i % 2], torch.bfloat16,
                         torch.float32, seed=i, decay=bool(i % 3),
                         name=f"p{i}") for i in range(n)]
    n0 = adamw_step.launches
    want = _plain_then_kernel(parts, cfg, scalars)
    torch.cuda.synchronize()
    assert adamw_step.launches == n0 + 3
    _assert_states_equal(parts, want)


@pytest.mark.parametrize("g", ADAMW_DTYPES)
def test_adamw_norm_is_plain_to_rounding_and_repeats(card, g):
    """The global norm over two tables of parts, one of them large: within
    1e-5 of ``_global_norm``, bitwise the same on a second call, and the
    clip scale computed from it as ``apply_updates``' plain branch does."""
    from repro_torch.kernels.adamw.adamw import (
        MAX_PARTS,
        adamw_sumsq,
    )
    from repro_torch.train.optimizer import _global_norm

    parts = [_adamw_part(1 + 1013 * i, torch.bfloat16, g, torch.float32,
                         seed=i) for i in range(MAX_PARTS + 7)]
    parts.append(_adamw_part(3_000_001, torch.bfloat16, g, torch.float32,
                             seed=99))
    want = _global_norm([pt.g for pt in parts])
    n0 = adamw_sumsq.launches
    for clip in (1.0, 1e6):
        out = adamw_sumsq(parts, clip)
        again = adamw_sumsq(parts, clip)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert float(out[0]) == pytest.approx(float(want), rel=1e-5)
        plain_scale = torch.clamp(clip / torch.clamp(out[0], min=1e-9),
                                  max=1.0)
        assert torch.equal(out[1], plain_scale)
    assert adamw_sumsq.launches == n0 + 4 * 3


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_on_the_card_runs_the_kernels(card, state_dtype):
    """``apply_updates`` on a CUDA tree of a bf16 matrix, an f32 vector and
    a stacked leaf of three layers: one launch of each kernel pair a step,
    and over three steps the parameters and moments bitwise the plain
    path's (the gradients' norm under the clip, so both scales are 1)."""
    from repro_torch.interop import Stacked
    from repro_torch.kernels.adamw.adamw import adamw_step, adamw_sumsq
    from repro_torch.train import optimizer as topt

    cfg = topt.AdamWConfig(clip_norm=1e3, warmup_steps=2, total_steps=50,
                           state_dtype=state_dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def tree(dt_w=torch.bfloat16):
        def r(*shape, dt=torch.float32):
            return torch.randn(shape, device="cuda", generator=gen).to(dt)

        return {"w": r(64, 40, dt=dt_w), "b": r(40),
                "layers": {"s": Stacked([r(33, 7, dt=torch.bfloat16)
                                         for _ in range(3)])}}

    def clone(t):
        return {"w": t["w"].clone(), "b": t["b"].clone(),
                "layers": {"s": Stacked([x.clone()
                                         for x in t["layers"]["s"].parts])}}

    params = tree()
    mine = clone(params)
    state = topt.init_state(cfg, params)
    ref_state = topt.init_state(cfg, mine)
    for _ in range(3):
        grads = tree()
        n0 = (adamw_sumsq.launches, adamw_step.launches)
        _, state, metrics = topt.apply_updates(cfg, params, grads, state)
        assert (adamw_sumsq.launches, adamw_step.launches) == (n0[0] + 2,
                                                               n0[1] + 1)
        # the plain path, as apply_updates runs it off the card
        step = ref_state["step"] + 1
        lr = topt.lr_at(cfg, ref_state["step"])
        bc1, bc2 = 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()
        gnorm = topt._plain_pass(cfg, topt._parts(mine, grads, ref_state),
                                 lr, bc1, bc2)
        ref_state["step"] = step
        assert float(gnorm) < cfg.clip_norm and float(
            metrics["grad_norm"]) == pytest.approx(float(gnorm), rel=1e-5)
        assert metrics["grad_norm"].device.type == "cuda"
    torch.cuda.synchronize()
    ours = topt._parts(params, params, state)
    theirs = topt._parts(mine, mine, ref_state)
    _assert_states_equal(ours, theirs)
    assert torch.equal(state["step"], ref_state["step"])


def test_adamw_wrapper_raises_on_what_it_does_not_take(card):
    from repro_torch.kernels.adamw.adamw import adamw_step, adamw_sumsq

    cfg, scalars = _adamw_scalars()
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay)
    half = _adamw_part(64, torch.float16, torch.bfloat16, torch.float32)
    with pytest.raises(TypeError, match="x: p is torch.float16"):
        adamw_step([half], *scalars, **kw)
    with pytest.raises(TypeError, match="x: p is torch.float16"):
        adamw_sumsq([half], 1.0)
    part = _adamw_part(64, torch.bfloat16, torch.bfloat16, torch.float32)
    strided = part._replace(
        p=torch.zeros((8, 16), dtype=torch.bfloat16,
                      device="cuda")[:, ::2])
    with pytest.raises(ValueError, match="x: p is not contiguous"):
        adamw_step([strided], *scalars, **kw)
    cpu = part._replace(p=part.p.cpu())
    with pytest.raises(ValueError, match="on cpu"):
        adamw_step([part, cpu._replace(name="y")], *scalars, **kw)
    with pytest.raises(TypeError, match="lr must be"):
        adamw_step([part], scalars[0].double(), *scalars[1:], **kw)


# ---- multi-head latent attention: the flash kernels at (192, 128) ------
# (docs/port.md §mla)


def _mla_inputs(seed, b=2, h=64, s=8192):
    """The Kimi K2 cell's launch shape (B 2, 64 heads, S 8192), bf16, laid
    out as the model's MLA block lays them out: q and k (B, S, H, 192)
    and v the second half of the (B, S, H, 256) up-projection, each a
    (B, H, S, ·) view; and an output gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(width):
        return torch.randn((b, s, h, width), generator=g,
                           device="cuda").bfloat16()

    q, k, kv, do = mk(192), mk(192), mk(256), mk(128)
    return (q.transpose(1, 2), k.transpose(1, 2),
            kv[..., 128:].transpose(1, 2), do.transpose(1, 2))


def test_mla_flash_forward_and_backward_equal_plain_at_the_cell_shape(card):
    """The Hopper forward and backward at D 192 for q and k and D 128 for
    v, at the cell's shape: the output, its log-sum-exp and dq, dk, dv
    against the plain versions (f32) on heads 0 and 1 of every batch row
    (the plain backward holds a (B, H, S, S) f32 matrix). Each launch
    counts under (192, 128). The output is within 2e-2 of the f32 plain
    (bf16 rounding of P and O), the gradients within 2e-3 in relative L2
    (measured ~3e-4)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    q, k, v, do = _mla_inputs(5)
    n = flash_attention.launches_at[192, 128]
    nb = flash_attention_bwd.launches_at[192, 128]
    o, lse, o32 = flash_attention(q, k, v, for_backward=True)
    assert o.shape == (2, 64, 8192, 128) and o32.shape == o.shape
    grads = flash_attention_bwd(q, k, v, o32, lse, do)
    assert flash_attention.launches_at[192, 128] == n + 1
    assert flash_attention_bwd.launches_at[192, 128] == nb + 1
    hs = slice(0, 2)
    want = flash_attention_plain(q[:, hs].float(), k[:, hs].float(),
                                 v[:, hs].float())
    assert (o[:, hs].float() - want).abs().max().item() < 2e-2
    torch.testing.assert_close(lse[:, hs], attention_lse_ref(q[:, hs],
                                                             k[:, hs]),
                               rtol=1e-5, atol=1e-5)
    plain = flash_attention_bwd_plain(q[:, hs], k[:, hs], v[:, hs],
                                      o32[:, hs], lse[:, hs], do[:, hs])
    for got, w, x in zip(grads, plain, (q, k, v)):
        assert got.shape == x.shape
        got, w = got[:, hs].float(), w.float()
        assert ((got - w).norm() / w.norm()).item() < 2e-3


def test_mla_flash_launches_are_deterministic(card):
    """Two launches of the (192, 128) forward and of its backward on the
    same inputs give the same bits."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    q, k, v, do = _mla_inputs(6, s=2048)
    first = flash_attention(q, k, v, for_backward=True)
    second = flash_attention(q, k, v, for_backward=True)
    for a, w in zip(first, second):
        assert torch.equal(a, w)
    _, lse, o32 = first
    g1 = flash_attention_bwd(q, k, v, o32, lse, do)
    g2 = flash_attention_bwd(q, k, v, o32, lse, do)
    for a, w in zip(g1, g2):
        assert torch.equal(a, w)


def _det_input(shape, salt):
    """A bf16 tensor on the card from a closed form of its flat index (no
    random generator): the same bits on any machine."""
    i = torch.arange(torch.Size(shape).numel(), dtype=torch.float64)
    x = torch.sin(i * 0.7318 + salt * 1.37) * 1.5 + torch.cos(i * 0.0131 +
                                                            salt)
    return x.float().reshape(shape).bfloat16().cuda()


#: SHA-256 (first 16 hex digits) of the outputs of the flash kernels at
#: D 64, 112 and 128 on :func:`_det_input`'s inputs, as the kernels gave
#: them when v's head dim was always k's (sm_90a, CUDA 12.8): templating
#: the kernels on (D, Dv) left them bitwise as they were.
FLASH_DIGESTS = {
    # (B, Hq, Hkv, Sq, Sk, D, causal, window): out, lse, o32, dq, dk, dv
    (2, 32, 8, 2048, 2048, 128, True, 4096): (
        "e5ba1daef5831928", "3845dbd9570637ef", "0d491818dea76342",
        "3340c7edbeb6f40e", "5d2af7360009b4ca", "678787aeb1c99c75"),
    (2, 4, 4, 300, 300, 64, False, 0): (
        "5727d18e074e5283", "60d4450fcdc52f91", "21161d8bef3a14fb",
        "4162a7af9325415a", "52245b1e6ec6beab", "06725a6d8f0358d5"),
    (2, 4, 4, 256, 256, 112, True, 0): (
        "0487678e7cedec06", "d8e6d9c9b0cb6e85", "9fa0f52964ae7ad8",
        "14d94755519d340d", "b53f6a6b25d767f8", "8494c044c605fb15"),
    (1, 8, 2, 512, 512, 128, True, 0): (
        "8ac8269f6aa33b0c", "235e5028cbf0d8f0", "2825256dd1d07575",
        "41e0f85b7ff6d77d", "f7917b3ed4b3b99a", "c401803a7bef75bd"),
}


@pytest.mark.parametrize("shape", list(FLASH_DIGESTS))
def test_flash_head_dims_64_112_128_are_bitwise_as_before(card, shape):
    """The forward (with and without what the backward needs) and the
    backward at the models' head dims give the bits they gave before the
    kernels took a v of its own width (:data:`FLASH_DIGESTS`)."""
    import hashlib

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    b, hq, hkv, sq, sk, d, causal, window = shape
    q, k, v, do = (_det_input(s, salt) for salt, s in enumerate(
        ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)),
        start=1))
    kw = dict(causal=causal, window=window)
    out = flash_attention(q, k, v, **kw, block_q=sq, block_k=sk)
    o, lse, o32 = flash_attention(q, k, v, **kw, block_q=sq, block_k=sk,
                                  for_backward=True)
    assert torch.equal(out, o)
    grads = flash_attention_bwd(q, k, v, o32, lse, do, **kw)

    def digest(t):
        t = t.contiguous().cpu()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(
            torch.uint8)
        return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]

    assert tuple(digest(t) for t in (out, lse, o32, *grads)) == \
        FLASH_DIGESTS[shape]


def test_mla_train_step_counts_its_flash_launches(card):
    """A narrow Kimi K2 (d_model 512, 4 heads, every head and latent at its
    published width, the dense layer and 4 expert layers, 8 of 64
    experts held) trains a step on the card through ``make_train_step``:
    each layer's attention is one (192, 128) forward launch in the forward
    and one in the remat recompute, and one backward call: 10 and 5 at 5
    layers; the loss is finite, and each MLA block counts ``mla.calls``."""
    import dataclasses

    from repro_torch import tracing
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import param_tree
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.models import registry
    from repro_torch.train.optimizer import AdamWConfig, init_state

    base = get_arch("kimi-k2-instruct")
    cfg = dataclasses.replace(
        base, n_layers=5, d_model=512, n_heads=4, n_kv_heads=4, d_ff=1024,
        vocab=1024, moe=dataclasses.replace(base.moe, n_experts=64, d_ff=256,
                                            n_held=8, held_start=8))
    bundle = registry.build(cfg, device="cuda")
    model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("t", 1024, 2, "train"),
                                device="cuda")
    opt_cfg = AdamWConfig()
    state = init_state(opt_cfg, param_tree(model))
    step = bundle.make_train_step(opt_cfg)
    n = flash_attention.launches_at[192, 128]
    nb = flash_attention_bwd.launches_at[192, 128]
    calls = tracing.snapshot().get("mla.calls", 0)
    model, state, metrics = step(model, state, batch)
    assert torch.isfinite(metrics["loss"])
    assert flash_attention.launches_at[192, 128] == n + 10
    assert flash_attention_bwd.launches_at[192, 128] == nb + 5
    assert tracing.snapshot()["mla.calls"] == calls + 10


class _Point:
    def __init__(self, block_h, m):
        self.m = m
        self.detail = {"block_rows": block_h}


@pytest.mark.parametrize("app", ["lbm", "diffusion"])
def test_model_pick_reaches_its_lattices_best(card, app):
    """At 2048², a grid no benchmark cell runs, the GPU model's first point
    by ``sustained_gflops`` of the (block_h, m) lattice runs at least 0.9
    of the lattice's best point, each timed on the run path: chained
    256-step simulations through ``run_for_point``, each ending in a
    synchronize, the median of three."""
    import statistics
    import time

    n = 2048
    if app == "lbm":
        sim = lbm.LBMSimulation(lbm.LBMProblem(n, n))
        kern = sim.stream_kernel()
        f, attr, _ = lbm.taylor_green_init(n, n)
        state, regs = sim.stream_state(f, attr), sim.stream_regs()
        ex = sim.explorer()
    else:
        sim = dif.DiffusionSimulation(n, n)
        kern = sim.kernel
        state, regs = sim.state(dif.sine_init(n, n)[0]), (sim.alpha,)
        ex = sim.explorer()
    bhs, ms = (8, 16, 32, 64), (1, 2, 4, 8)
    pick = ex.sweep_gpu(bh_values=bhs, m_values=ms,
                        d_values=(1,)).best(key="sustained_gflops")

    def rate(bh, m):
        point = _Point(bh, m)
        kern.run_for_point(state, regs, point=point, steps=m)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = kern.run_for_point(state, regs, point=point, steps=256)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        del out
        return n * n * 256 / statistics.median(walls)

    rates = {(bh, m): rate(bh, m) for bh in bhs for m in ms}
    got = rates[pick.detail["block_rows"], pick.m]
    best = max(rates.values())
    assert got >= 0.9 * best, (pick.detail["block_rows"], pick.m,
                               sorted(rates.items(), key=lambda kv: -kv[1]))
