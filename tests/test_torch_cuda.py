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
    for overlap in (True, False):
        assert torch.equal(sk.run_blocked(state, regs, steps=8, m=4,
                                          block_h=8, overlap=overlap),
                           single)
    assert torch.equal(sk.multistep(state, regs, m=4, block_h=8),
                       kern.run_blocked(state, regs, steps=4, m=4,
                                        block_h=8))


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
    for d in (64, 128):
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


def test_flash_launch_faults_raise(card):
    """No fallback on the bf16 path: a head dim the library does not
    instantiate and a TMA descriptor the driver refuses (a base off
    16-byte alignment) raise from the C entry point."""
    from repro_torch.kernels.build import (
        FlashStrides,
        check,
        load_flash_library,
    )

    lib = load_flash_library()
    x = torch.zeros((1, 1, 256, 128), dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call(ptr, d):
        st = FlashStrides()
        for i in range(4):
            st.s[3 * i:3 * i + 3] = [256 * d, 256 * d, d]
        return lib.flash_attention_fwd(ptr, ptr, ptr, out.data_ptr(), 1, 1,
                                       1, 1, 128, 128, d, st, 0.1, 1, 0,
                                       stream)

    with pytest.raises(RuntimeError, match="no instantiation"):
        check(call(x.data_ptr(), 96), "flash_attention")
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
