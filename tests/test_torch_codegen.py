"""The port's StreamKernel on the CPU against the JAX StreamKernel.

Inputs are made with numpy from a seed and handed to both packages. The
port's plain version (the IR interpreted over the launch's tiles) must
equal the port's own full-grid reference bit for bit, and the JAX
package's kernel within rtol 2e-5 / atol 1e-6: XLA on the CPU and torch
round the same op tree at the same points, but multi-step runs compound
last-bit differences (different summation trees in XLA fusions).
"""

import numpy as np
import pytest
import torch

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core import CodegenError
from repro_torch.kernels.spd_stream.spd_stream import spd_multistep_plain

RTOL, ATOL = 2e-5, 1e-6
TGV_REGS = (1 / 0.8, 0.0, 1.0)
COUETTE_REGS = (1 / 0.9, 0.07, 1.0)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def dif_pair():
    return (tdif.DiffusionSimulation(32, 128, alpha=0.2, device="cpu"),
            jdif.DiffusionSimulation(32, 128, alpha=0.2))


def _dif_state(seed=0):
    u0, _ = jdif.sine_init(32, 128)
    noise = np.random.default_rng(seed).standard_normal((32, 128))
    return np.asarray(u0) + 0.01 * noise.astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_diffusion_matches_jax(dif_pair, m):
    tsim, jsim = dif_pair
    u = _dif_state()
    got = tsim.kernel(tsim.state(u), (0.2,), m=m, block_h=8)
    want = jsim.kernel.reference(jsim.state(u), (0.2,), m=m)
    _close(got, want)
    assert torch.equal(got, tsim.kernel.reference(tsim.state(u), (0.2,),
                                                  m=m))


def test_diffusion_matches_jax_interpret_launch(dif_pair):
    """One case against the JAX package's own Pallas launch, run in
    interpret mode as its tests run it."""
    tsim, jsim = dif_pair
    u = _dif_state(1)
    got = tsim.kernel.run_blocked(tsim.state(u), (0.2,), steps=4, m=2,
                                  block_h=8)
    want = jsim.kernel.run_blocked(jsim.state(u), (0.2,), steps=4, m=2,
                                   block_h=8, interpret=True)
    _close(got, want)


@pytest.fixture(scope="module", params=["hdl", "spd"])
def lbm_pair(request):
    prob = dict(height=16, width=128)
    tsim = tlbm.LBMSimulation(tlbm.LBMProblem(**prob), bndry=request.param,
                              device="cpu")
    jsim = jlbm.LBMSimulation(jlbm.LBMProblem(**prob), bndry=request.param)
    return tsim.stream_kernel(), jsim.stream_kernel()


def _lbm_fields(case):
    if case == "tgv":
        f, attr, _ = jlbm.taylor_green_init(16, 128)
        regs = TGV_REGS
    else:
        f, attr = jlbm.couette_init(16, 128)
        regs = COUETTE_REGS
    rng = np.random.default_rng(7)
    f = np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, 16, 128)))
    return f.astype(np.float32), np.asarray(attr), regs


@pytest.mark.parametrize("case", ["tgv", "couette"])
@pytest.mark.parametrize("m", [1, 4])
def test_ulbm_pe_matches_jax(lbm_pair, case, m):
    tk, jk = lbm_pair
    f, attr, regs = _lbm_fields(case)
    state = tk.pack(list(f) + [attr])
    got = tk(state, regs, m=m, block_h=8)
    want = jk.reference(jk.pack(list(f) + [attr]), regs, m=m)
    _close(got, want)
    assert torch.equal(got, tk.reference(state, regs, m=m))


def test_tiling_invariance_is_bitwise(lbm_pair):
    """Every (block_h, block_w) plan — ragged last column tiles included —
    and both launches give the same bits."""
    tk, _ = lbm_pair
    f, attr, regs = _lbm_fields("couette")
    state = tk.pack(list(f) + [attr])
    want = tk.reference(state, regs, m=2)
    assert torch.equal(tk.multistep(state, regs, m=2, block_h=16), want)
    for block_h, block_w in [(4, 32), (8, 48), (16, 17), (2, 128)]:
        got = spd_multistep_plain(tk.program, state, regs, m=2,
                                  block_h=block_h, block_w=block_w)
        assert torch.equal(got, want), (block_h, block_w)
    for db in (True, False):
        assert torch.equal(tk(state, regs, m=2, block_h=8, block_w=40,
                              double_buffer=db), want)


def test_run_blocked_and_run_for_point(lbm_pair):
    tk, _ = lbm_pair
    f, attr, regs = _lbm_fields("tgv")
    state = tk.pack(list(f) + [attr])
    got = tk.run_blocked(state, regs, steps=8, m=4, block_h=8)
    assert torch.equal(got, tk.reference(state, regs, m=8))

    class Point:
        m, detail = 4, {"block_rows": 12}

    out, (bh, m, db) = tk.run_for_point(state, regs, point=Point(), steps=8)
    # The streamed plan at width 128: the register-state kernel takes one
    # block per SM and the widest tile whose stripe its 2,048 owned cells
    # hold: 8×128 (16×136 cells) fits shared memory but not the owners,
    # 8×64 (16×72) both, so the next tile's copies go into the one load
    # slot while this tile steps.
    assert (bh, m, db) == (8, 4, True)
    assert tk.tile(128, 8, 4) == (64, True)
    assert torch.equal(out, got)


def test_kernel_rejects_illegal_plans_and_batches(dif_pair):
    tsim, _ = dif_pair
    state = tsim.state(_dif_state())
    with pytest.raises(ValueError):
        tsim.kernel(state, (0.2,), m=1, block_h=5)  # 32 % 5 != 0
    with pytest.raises(ValueError):
        tsim.kernel(state, (0.2,), m=16, block_h=8)  # m*halo > block_h
    with pytest.raises(CodegenError):
        tsim.kernel(state, (), m=1, block_h=8)  # wrong register count
    # a batch runs through the periodic launches (test_torch_sim.py); the
    # halo launches, the mesh and the reference take one member, and a
    # batch of the wrong port count or rank is refused
    from repro_torch.kernels.spd_stream.sharded import spd_multistep_halo

    batch = torch.stack([state, state])
    with pytest.raises(CodegenError, match="batched"):
        spd_multistep_halo(tsim.kernel.program, batch, (0.2,), m=1,
                           block_h=8)
    with pytest.raises(CodegenError, match="batched"):
        tsim.kernel.reference(batch, (0.2,), m=1)
    with pytest.raises(CodegenError, match="batched"):
        tsim.kernel.sharded(2, devices=["cpu"] * 2).run_blocked(
            batch, (0.2,), steps=1, m=1, block_h=8)
    with pytest.raises(CodegenError):
        tsim.kernel(batch[None], (0.2,), m=1, block_h=8)
    with pytest.raises(CodegenError):
        tsim.kernel(torch.cat([batch, batch], dim=1), (0.2,), m=1,
                    block_h=8)


def test_x_offsets_beyond_row_width_wrap():
    """A dx larger than the grid width wraps like roll, through the
    guard columns loaded mod W."""
    from repro_torch.core import Registry, parse_spd

    kern = Registry().compile(parse_spd("""
        Name BigDX;
        Main_In {mi::u};
        Main_Out {mo::v};
        HDL S1, 0, (t) = Stencil2D(u), dy=0, dx=11, W=8, mode=wrap;
        EQU N1, v = t + 0.0;
    """)).stream_kernel(device="cpu")
    state = kern.pack([np.random.default_rng(0).standard_normal((8, 8))])
    assert torch.equal(kern(state, m=1, block_h=8),
                       kern.reference(state, m=1))


def test_diffusion_physics_decay():
    sim = tdif.DiffusionSimulation(32, 128, alpha=0.2, device="cpu")
    u0, decay = tdif.sine_init(32, 128, device="cpu")
    u = sim.run(u0, 40, m=4, block_h=8)
    ratio = float(torch.linalg.norm(u) / torch.linalg.norm(u0))
    assert ratio == pytest.approx(decay(0.2) ** 40, rel=1e-4)


def test_diffusion_oracle_and_default_block():
    sim = tdif.DiffusionSimulation(30, 64, alpha=0.2, device="cpu")
    u0, _ = tdif.sine_init(30, 64, device="cpu")
    got = sim.run(u0, 2, m=2)
    _close(got, jdif.diffusion_ref_run(np.asarray(u0), 0.2, 2))
    _close(tdif.diffusion_ref_run(u0, 0.2, 2),
           jdif.diffusion_ref_run(np.asarray(u0), 0.2, 2))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdif.DiffusionSimulation(16, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlbm.LBMSimulation(tlbm.LBMProblem(16, 64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlbm.taylor_green_init(16, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdif.compile_diffusion(64).stream_kernel()


@pytest.mark.parametrize("app", ["diffusion", "ulbm"])
def test_printed_step_divides_no_cell_index(app, dif_pair, lbm_pair):
    """The printed ``SpdCore::step`` walks its cells without dividing an
    index: one loop per phase over ``idx``, every stencil tap one load at
    a constant offset from ``idx``, so no phase needs the cell's (r, c);
    no ``/`` or ``%`` by the tile width in any phase loop."""
    import re

    prog = (dif_pair[0].kernel if app == "diffusion"
            else lbm_pair[0]).program
    body = prog.cuda_source().split("struct SpdCore", 1)[1]
    loops = re.findall(r"for \(int idx = threadIdx\.x; idx < RC; "
                       r"idx \+= SPD_THREADS\) \{\n(.*?)\n    \}", body,
                       re.S)
    assert len(loops) == len(prog.phases)
    for phase, loop in zip(prog.phases, loops):
        assert not re.search(r"(idx|r|c)\s*[/%]|[/%]\s*(C|R|RC)\b", loop)
        assert "%" not in loop
        assert "c += t.dc;" not in loop
        shifts = [st for st in phase if st.op == "shift"]
        taps = re.findall(r"RC \+ idx - \((-?\d+) \* C \+ \((-?\d+)\)\)\]",
                          loop)
        assert sorted(taps) == sorted((str(st.dy), str(st.dx))
                                      for st in shifts)
    assert "const int r = idx / C" not in body


def test_in_place_step_only_without_input_stencils(dif_pair, lbm_pair):
    """A step may write over its input when its last phase reads the state
    pointwise only: the uLBM PE (every stencil read is of the
    post-collision intermediates), not diffusion (it stencils its input).
    The printed source says so, and its two state pointers carry no
    ``__restrict__``, as they may be one buffer."""
    dprog, pprog = dif_pair[0].kernel.program, lbm_pair[0].program
    assert not dprog.in_place and pprog.in_place
    for prog in (dprog, pprog):
        src = prog.cuda_source()
        flag = "true" if prog.in_place else "false"
        assert f"static constexpr bool IN_PLACE = {flag};" in src
        assert "const float* src, float* dst," in src
        # The uLBM PE keeps its state in registers beside one load slot;
        # diffusion ping/pongs two shared buffers.
        assert prog.launch_planes(streamed=True, double_buffer=False) == \
            prog.planes(1 if prog.in_place else 2)
        assert prog.launch_planes(streamed=False, double_buffer=False) == \
            prog.planes(1 if prog.in_place else 2)


def _core(text):
    from repro_torch.core import Registry, parse_spd

    return Registry().compile(parse_spd(text)).stream_kernel(device="cpu")


#: A core that stencils its state in a later phase than the first: phase
#: 0 materializes a, phase 1 taps a and the state u.
LATE_STATE_STENCIL = """
    Name Late;
    Main_In {mi::u};
    Main_Out {mo::v};
    EQU N0, a = u * 2.0;
    HDL S1, 0, (b) = Stencil2D(a), dy=1, dx=0, W=8, mode=wrap;
    HDL S2, 0, (c) = Stencil2D(u), dy=0, dx=1, W=8, mode=wrap;
    EQU N1, v = b + c;
"""


@pytest.mark.parametrize("bndry", ["hdl", "spd"])
def test_register_state_only_without_state_stencils(bndry, dif_pair):
    """A core keeps its state in registers when no phase reads a state
    plane by stencil: the uLBM PE (both boundary variants), not diffusion
    (it taps its input) nor a core that taps its state in a later phase."""
    prog = tlbm.LBMSimulation(tlbm.LBMProblem(16, 64), bndry=bndry,
                              device="cpu").stream_kernel().program
    assert prog.reg_state and prog.in_place
    assert (prog.threads, prog.cpt, prog.owner_cells) == (1024, 2, 2048)
    late = _core(LATE_STATE_STENCIL).program
    assert len(late.phases) == 2
    for other in (dif_pair[0].kernel.program, late):
        assert not other.reg_state and other.owner_cells == 0
        assert "REG_STATE = false" in other.cuda_source()


def test_printed_register_step_and_offset_taps(dif_pair, lbm_pair):
    """The uLBM PE's printed source keeps each owned cell's state in
    registers (``step_owned`` reads and writes ``s[q][p]``, never a shared
    state plane) and no stencil tap checks bounds; diffusion prints the
    shared-state step only, its taps unchecked too. Every printed unit
    (diffusion, the PE at either boundary, a cluster core of the uLBM
    program) fixes its owner layout once, from codegen's constants, with
    nothing left to override, and neither it nor the headers it includes
    has a bounds-checked tap or per-cell (r, c) of the owned cells."""
    import re

    from repro_torch.kernels.build import CSRC

    src = lbm_pair[0].program.cuda_source()
    assert "static constexpr bool REG_STATE = true;" in src
    assert "#define SPD_THREADS 1024" in src and "#define SPD_CPT 2" in src
    owned = src.split("step_owned(", 1)[1]
    assert "src[" not in owned and "dst[" not in owned
    assert len(re.findall(r"= s\[q\]\[\d\];", owned)) == 10 + 1  # in9
    assert len(re.findall(r"s\[q\]\[\d\] = ", owned)) == 10
    assert len(re.findall(r"mat\[\d \* RC \+ idx - \(", owned)) == 9
    dsrc = dif_pair[0].kernel.program.cuda_source()
    assert "step_owned" not in dsrc and "SPD_CPT" not in dsrc
    cluster = tlbm.LBMSimulation(tlbm.LBMProblem(16, 64),
                                 device="cpu").program().cluster_kernel(0, 1)
    headers = "".join((CSRC / h).read_text()
                      for h in ("spd_tile.cuh", "spd_stream.cuh",
                                "tile_copy.cuh"))
    for prog in (dif_pair[0].kernel.program, lbm_pair[0].program,
                 cluster.program):
        unit = prog.cuda_source()
        layout = {"SPD_THREADS": prog.threads,
                  "SPD_MIN_BLOCKS": prog.blocks_per_sm}
        if prog.reg_state:
            layout["SPD_CPT"] = prog.cpt
        for macro, value in layout.items():
            assert len(re.findall(rf"#define {macro} ", unit)) == 1
            assert f"#define {macro} {value}\n" in unit
        assert ("SPD_CPT" in unit) == prog.reg_state
        assert "#ifndef SPD_" not in unit + headers
        for name in ("spd_tap", "SpdOwned"):
            assert name not in unit + headers
    assert cluster.program.reg_state


def test_tile_takes_the_owner_rule_of_the_kernel(dif_pair, lbm_pair):
    """Both launches price the uLBM PE at P + K = 19 planes and 4 guard
    rows, whichever walk a tile takes; a stripe within the 2,048 owned
    cells keeps its state in registers (prefetched in the streamed
    launch), a larger one in the slot without prefetch — the rule the
    kernel applies — and the plan narrows a tile to one the owners hold.
    Diffusion ping/pongs two shared planes, plus the streamed launch's
    second slot."""
    pe, dprog = lbm_pair[0].program, dif_pair[0].kernel.program
    for streamed in (True, False):
        for db in (True, False):
            assert pe.launch_planes(streamed=streamed, double_buffer=db) == 19
            assert dprog.launch_planes(streamed=streamed,
                                       double_buffer=db) == \
                2 + (streamed and db)
    assert pe.owned(16, 64, 4) and pe.owned(20, 64, 4)  # 1,728, 2,016 cells
    assert not pe.owned(8, 128, 4)  # 2,176 cells
    assert pe.tile(4096, 16, 4) == (64, True)
    assert pe.tile(4096, 8, 4) == (64, True)  # narrowed from 128
    assert pe.tile(4096, 8, 4, block_w=128) == (128, False)
    assert pe.tile(4096, 16, 4, streamed=False) == (64, False)
    assert pe.tile(720, 20, 4) == (64, True)
    assert pe.smem_bytes(16, 64, 4, streamed=True, double_buffer=False) == \
        (24 * 19 + 4) * 72 * 4
    assert not dprog.owned(32, 128, 4)
    assert dprog.tile(8192, 32, 4) == (128, True)
    assert dprog.tile(8192, 32, 4, streamed=False) == (128, False)


def test_stencil_chains_beyond_the_halo_are_refused():
    """A shift and its opposite cancel in the composed halo but not in the
    reads: such a core is refused, since the tile's guard cells would not
    cover its taps."""
    with pytest.raises(CodegenError, match="beyond the composed halo"):
        _core("""
            Name Cancel;
            Main_In {mi::u};
            Main_Out {mo::v};
            HDL S1, 0, (a) = Stencil2D(u), dy=0, dx=1, W=8, mode=wrap;
            EQU N0, b = a * 2.0;
            HDL S2, 0, (v) = Stencil2D(b), dy=0, dx=-1, W=8, mode=wrap;
        """)


def test_pack_batch_stacks_and_refuses(lbm_pair):
    """``pack_batch`` stacks numpy or torch ``(P, H, W)`` states into a
    ``(B, P, H, W)`` f32 batch on the kernel's device; an empty list or
    mixed geometries raise, as in the reference."""
    kern = lbm_pair[0]
    f, attr, _ = _lbm_fields("tgv")
    states = [np.concatenate([f * np.float32(1 + 0.001 * i),
                              attr[None].astype(np.float32)])
              for i in range(3)]
    batch = kern.pack_batch([states[0], torch.from_numpy(states[1]),
                             states[2]])
    assert batch.shape == (3, 10, 16, 128) and batch.dtype == torch.float32
    assert batch.device == kern.device
    for i, s in enumerate(states):
        assert np.array_equal(batch[i].numpy(), s)
    with pytest.raises(CodegenError, match="at least one"):
        kern.pack_batch([])
    with pytest.raises(CodegenError, match="geometry"):
        kern.pack_batch([states[0], states[1][:, :8]])
