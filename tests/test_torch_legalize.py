"""The port's legalizer: the copied functions equal the JAX package's at
the JAX budget, and the Hopper tile pricing is what the kernels allocate."""

import itertools

import pytest

from repro.core import legalize as jleg
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core import legalize as tleg
from repro_torch.kernels.lbm_stream.lbm_stream import LBM_PLANES, lbm_owned


class _Point:
    def __init__(self, m, block_rows, **detail):
        self.m = m
        self.detail = {"block_rows": block_rows, **detail}


_GRID = list(itertools.product(
    (16, 30, 64, 300, 4096),  # h
    (1, 7, 32, 4096),  # block_h
    (1, 2, 4, 9),  # m
    (0, 1, 2),  # halo
))


@pytest.mark.parametrize("width,words,db", [
    (0, 0, True), (720, 10, True), (100_000, 200, False),
])
def test_blocking_functions_equal(width, words, db):
    for h, block_h, m, halo in _GRID:
        kw = dict(halo=halo, width=width, words=words, double_buffer=db)
        for fn in ("blocking_plan", "legal_block_values",
                   "constraint_violation"):
            args = (h, block_h, m) if fn != "legal_block_values" else (h, m)
            try:
                want = getattr(jleg, fn)(*args, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    getattr(tleg, fn)(*args, **kw)
                continue
            assert getattr(tleg, fn)(*args, **kw) == want, (fn, args, kw)


def test_pricing_and_plan_identity_equal():
    assert tleg.VMEM_BYTES == jleg.VMEM_BYTES
    assert tleg.PLAN_FIELDS == jleg.PLAN_FIELDS
    for args in itertools.product((8, 32), (1, 4), (128, 720), (1, 10),
                                  (0, 1), (True, False), (1, 3), (0, 1)):
        bh, m, w, words, halo, db, b, hx = args
        assert (tleg.stripe_vmem_bytes(bh, m, w, words, halo, db, b, hx)
                == jleg.stripe_vmem_bytes(bh, m, w, words, halo, db, b, hx))
    rec = {"block_h": 8, "m": 2, "steps": 4, "d": 1, "reps": 3}
    assert (tleg.RunPlan.from_dict(rec).key()
            == jleg.RunPlan.from_dict(rec).key())
    stages = [(10, 1), (10, 0), (10, 0)]
    for fusion in ("", "1+2", "1+1+1"):
        assert (tleg.program_blocking_plan(300, 64, 4, stages=stages,
                                           fusion=fusion, width=720)
                == jleg.program_blocking_plan(300, 64, 4, stages=stages,
                                              fusion=fusion, width=720))


@pytest.mark.parametrize("point", [
    _Point(4, 16), _Point(8, 4096), _Point(2, 7, double_buffer=False),
])
def test_resolve_run_plan_equal(point):
    for h, steps, halo in itertools.product((300, 4096), (None, 9), (1, 2)):
        assert (tleg.resolve_run_plan(h, point, steps, halo=halo)
                == jleg.resolve_run_plan(h, point, steps, halo=halo))


def test_tile_pricing_matches_the_kernels_layout():
    """Generated kernel: nbuf·P + K planes of (bh+2mh)×(bw+2mw) f32 cells
    — the issue's uLBM sizing at block 16×32, m 4 — and the LBM kernel's
    19 planes; launch_tile picks the widest column tile that fits."""
    kern = tlbm.LBMSimulation(tlbm.LBMProblem(32, 720), device="cpu") \
        .stream_kernel()
    prog = kern.program
    price = lambda nbuf: tleg.tile_smem_bytes(  # noqa: E731
        16, 32, 4, halo=1, halo_x=1, planes=prog.planes(nbuf))
    assert price(2) == 29 * 24 * 40 * 4 == 111_360
    assert price(3) == 111_360 + 38_400 == 149_760
    # Both launches keep the PE's state in registers beside one load slot
    # (P + K = 19 planes) with 2·(halo + 1) guard rows, one block per SM:
    # 16×32 at m 4 is 19·24·40·4 + 4·40·4 = 73,600 B; the plan's 16×64,
    # 132,480 B, its 1,728-cell stripe within the 2,048 owned cells.
    assert prog.in_place and prog.reg_state
    assert prog.launch_planes(streamed=True, double_buffer=True) == 19
    assert prog.launch_planes(streamed=False, double_buffer=False) == 19
    assert prog.guard_rows == 4
    assert prog.smem_bytes(16, 32, 4, streamed=True, double_buffer=True) \
        == 73_600
    assert kern.tile(720, 16, 4) == (64, True)
    assert kern.tile(720, 16, 4, double_buffer=False,
                     streamed=False) == (64, False)
    assert (tleg.tile_smem_bytes(32, 128, 4, halo=1, halo_x=1,
                                 planes=LBM_PLANES)
            == 40 * 136 * 19 * 4)
    dif = tdif.DiffusionSimulation(64, 8192, device="cpu").kernel
    assert dif.tile(8192, 32, 4) == (128, True)


def test_launch_tile_shrinks_falls_back_and_rejects():
    planes = lambda db: 30 if db else 20  # noqa: E731
    bw, db = tleg.launch_tile(4096, 64, 4, halo=1, halo_x=1, planes=planes)
    assert db and tleg.tile_smem_bytes(64, bw, 4, halo=1, halo_x=1,
                                       planes=30) <= tleg.SMEM_BYTES
    assert tleg.tile_smem_bytes(64, 2 * bw, 4, halo=1, halo_x=1,
                                planes=30) > tleg.SMEM_BYTES
    # A width under MAX_BLOCK_W is taken whole (ragged tiles need no mask).
    assert tleg.launch_tile(40, 8, 1, halo=1, halo_x=1,
                            planes=planes) == (40, True)
    # No prefetching tile fits, a single-buffer one does.
    bw, db = tleg.launch_tile(64, 40, 4, halo=1, halo_x=1,
                              planes=lambda d: 200 if d else 60)
    assert not db and bw >= 1
    # An explicit tile is checked, never shrunk.
    with pytest.raises(ValueError, match="shared memory"):
        tleg.launch_tile(4096, 64, 4, halo=1, halo_x=1, planes=planes,
                         block_w=512, double_buffer=False)
    with pytest.raises(ValueError, match="shared memory"):
        tleg.launch_tile(64, 4000, 1, halo=1, halo_x=1, planes=planes)


def test_launch_tile_two_blocks_per_sm_and_cell_cap():
    """``blocks_per_sm=2`` takes the widest tile with room for two blocks
    on an SM (two-slot where it fits at that width, else one-slot) before
    the one-block rule; the LBM kernel's tile is priced by shared memory
    alone."""
    planes = lambda db: 39 if db else 29  # noqa: E731  (the uLBM PE)
    price = lambda bw, db: tleg.tile_smem_bytes(  # noqa: E731
        16, bw, 4, halo=1, halo_x=1, planes=planes(db))
    assert tleg.block_smem_budget(1) == tleg.SMEM_BYTES
    assert 2 * (tleg.block_smem_budget(2) + tleg.BLOCK_RESERVED_BYTES) \
        <= tleg.SM_SMEM_BYTES
    bw, db = tleg.launch_tile(4096, 16, 4, halo=1, halo_x=1, planes=planes,
                              blocks_per_sm=2)
    assert (bw, db) == (32, False)
    assert price(32, True) > tleg.block_smem_budget(2) >= price(32, False)
    # Diffusion's two-slot tile already leaves room for three blocks.
    assert tleg.launch_tile(8192, 32, 4, halo=1, halo_x=1,
                            planes=lambda db: 3 if db else 2,
                            blocks_per_sm=2) == (128, True)
    # No tile leaves room for two blocks: the one-block rule.
    big = lambda db: 60 if db else 50  # noqa: E731
    assert tleg.launch_tile(4096, 64, 4, halo=1, halo_x=1, planes=big,
                            blocks_per_sm=2) == tleg.launch_tile(
        4096, 64, 4, halo=1, halo_x=1, planes=big) == (4, True)
    # An explicit tile is checked against one block, never shrunk.
    assert tleg.launch_tile(4096, 16, 4, halo=1, halo_x=1, planes=planes,
                            block_w=32, blocks_per_sm=2) == (32, True)
    # The LBM kernel takes every tile that fits shared memory: 24 rows ×
    # (64 + 8) = 1,728 cells at block_h 16 fit the 2,048 its threads own,
    # 32 × 72 = 2,304 at block_h 24 do not and run with the populations in
    # the load slot; 264 × 10 at block_h 256 likewise.
    lbm = lambda bh, w=4096: tleg.launch_tile(  # noqa: E731
        w, bh, 4, halo=1, halo_x=1, planes=lambda db: 19,
        double_buffer=False)
    assert lbm(16) == (64, False) and lbm_owned(16, 64, 4)
    assert lbm(24) == (64, False) and not lbm_owned(24, 64, 4)
    assert lbm(256, 64) == (2, False) and not lbm_owned(256, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tleg.launch_tile(4096, 16, 4, halo=1, halo_x=1,
                         planes=lambda db: 19, block_w=128,
                         double_buffer=False)
