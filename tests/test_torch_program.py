"""Stream programs on the port (``repro_torch.core.program``): the fusion
axis, against the JAX package's ``core/program.py`` and inside the port.

* Against JAX: every partition of the 3-core LBM program (Couette walls
  and a moving lid, so the boundary stage bites, plus seeded noise) at m 2
  equals the JAX ``ProgramKernel.run_blocked`` in interpret mode within
  rtol 2e-5 / atol 1e-6 (XLA and torch round the same f32 operations, but
  may sum the nine populations in another order); the SPD texts, the
  cluster wrappers and the model workload are the reference's.
* Inside the port, bitwise (``tests/test_program.py`` one test to one
  test, both apps as cases of one test): every partition equals the
  monolithic kernel at m ∈ {1, 2, 4} × double_buffer, equals the
  compiler's reference path, and equals itself sharded over ``["cpu"] *
  2``; ``run_unfused`` crosses to the host once per cluster per step; the
  fusion axis rides sweep → search → executed points and cache keys.
* The GPU model prices each cluster's own tile: its ``smem`` rule
  accepts exactly the points whose every cluster tile fits a block.
"""

import numpy as np
import pytest
import torch

from repro.apps import lbm as jlbm
from repro_torch.apps import lbm as tlbm
from repro_torch.apps.advection_diffusion import (
    AdvectionDiffusionSimulation,
    blob_init,
)
from repro_torch.core.legalize import SMEM_BYTES
from repro_torch.core.program import (
    ProgramError,
    StreamProgram,
    fusion_partitions,
    program_run_factory,
)

H, W = 16, 64
STEPS = 4
RTOL, ATOL = 2e-5, 1e-6
LID = 0.07


def _couette_state(h, w):
    """Couette populations with 1% seeded noise, and their walls."""
    f, attr = jlbm.couette_init(h, w)
    rng = np.random.default_rng(0)
    f = np.asarray(f) * (1 + 0.01 * rng.standard_normal((9, h, w)))
    return f.astype(np.float32), np.asarray(attr, np.float32)


@pytest.fixture(scope="module")
def lbm_app():
    sim = tlbm.LBMSimulation(tlbm.LBMProblem(H, W, u_lid=LID), device="cpu")
    f, attr = _couette_state(H, W)
    return {
        "prog": sim.program(),
        "mono": sim.stream_kernel(),
        "state": sim.stream_state(f, torch.from_numpy(attr)),
        "regs": sim.stream_regs(),
        "numpy": (f, attr),
    }


@pytest.fixture(scope="module")
def ad_app():
    sim = AdvectionDiffusionSimulation(H, W, device="cpu")
    rng = np.random.default_rng(1)
    u = blob_init(H, W, device="cpu") + torch.from_numpy(
        (0.01 * rng.standard_normal((H, W))).astype(np.float32))
    return {
        "sim": sim,
        "prog": sim.program,
        "mono": sim.monolithic_core.stream_kernel(device="cpu"),
        "state": sim.state(u),
        "regs": sim.regs(),
    }


@pytest.fixture()
def app(request):
    return request.getfixturevalue(request.param)


APPS = pytest.mark.parametrize("app", ["lbm_app", "ad_app"], indirect=True)


@pytest.fixture(scope="module")
def jax_lbm_runs():
    """The JAX program, every partition at m 2, on the same numpy input."""
    sim = jlbm.LBMSimulation(jlbm.LBMProblem(H, W, u_lid=LID))
    prog = sim.program()
    f, attr = _couette_state(H, W)
    state = sim.stream_state(f, attr)
    return {
        spec: np.asarray(prog.kernel(spec).run_blocked(
            state, sim.stream_regs(), steps=STEPS, m=2, block_h=8,
            interpret=True))
        for spec in fusion_partitions(prog.nstages)
    }


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", fusion_partitions(3))
def test_lbm_partitions_match_jax(lbm_app, jax_lbm_runs, spec):
    got = lbm_app["prog"].kernel(spec).run_blocked(
        lbm_app["state"], lbm_app["regs"], steps=STEPS, m=2, block_h=8)
    np.testing.assert_allclose(got.numpy(), jax_lbm_runs[spec], rtol=RTOL,
                               atol=ATOL)


def test_fusion_partitions_enumeration():
    from repro.core.program import fusion_partitions as jparts

    assert fusion_partitions(1) == ("1",)
    assert fusion_partitions(2) == ("2", "1+1")
    assert fusion_partitions(3) == ("3", "2+1", "1+2", "1+1+1")
    assert len(fusion_partitions(4)) == 8  # 2^(n-1) compositions
    for n in range(1, 6):
        assert fusion_partitions(n) == jparts(n)


def test_lbm_spd_texts_and_wrappers_match_jax(lbm_app, ad_app):
    """The stage cores and every cluster wrapper are the reference's SPD
    text, so both packages compile the same cores."""
    from repro.apps.advection_diffusion import advdiff_program

    assert tlbm.collide_stream_spd(W) == jlbm.collide_stream_spd(W)
    assert tlbm.moments_spd() == jlbm.moments_spd()
    for bndry in ("hdl", "spd"):
        assert (tlbm.bndry_stage_spd(bndry=bndry)
                == jlbm.bndry_stage_spd(bndry=bndry))
    for prog, jprog in ((lbm_app["prog"], jlbm.lbm_program(W)),
                        (ad_app["prog"], advdiff_program(W))):
        assert prog.reg_names() == jprog.reg_names()
        for lo in range(prog.nstages):
            for hi in range(lo + 1, prog.nstages + 1):
                assert prog._cluster_spd(lo, hi) == jprog._cluster_spd(lo, hi)
                assert prog.reg_slice(lo, hi) == jprog.reg_slice(lo, hi)


@APPS
def test_workload_matches_jax(app):
    """The model's view of the program (per-stage flops, words and halos,
    the fused totals) is the reference's."""
    from repro.apps.advection_diffusion import advdiff_program

    prog = app["prog"]
    jprog = (jlbm.lbm_program(W) if prog.nstages == 3
             else advdiff_program(W))
    got, want = prog.workload(H * W, W), jprog.workload(H * W, W)
    for field in ("flops_per_elem", "words_in", "words_out", "depth",
                  "buffer_bits", "elems", "grid_w", "halo", "stages"):
        assert getattr(got, field) == getattr(want, field), field
    assert prog.stage_geometry() == jprog.stage_geometry()


# --------------------------------------------------------------------------
# Partition structure
# --------------------------------------------------------------------------


def test_program_rejects_non_chain_graphs(ad_app):
    reg = ad_app["prog"].registry
    with pytest.raises(ProgramError, match="not a chain edge"):
        StreamProgram(reg, ["Advect2D", "ReactDiffuse2D"], edges=[(1, 0)],
                      width=W, device="cpu")
    with pytest.raises(ProgramError, match="disconnected"):
        StreamProgram(reg, ["Advect2D", "ReactDiffuse2D"], edges=[],
                      width=W, device="cpu")


def test_stage_geometry(lbm_app, ad_app):
    # uLBM: collide+stream carries the 9-dir stencil (halo 1); the
    # boundary and moments stages are pointwise (halo 0).
    assert lbm_app["prog"].stage_geometry() == ((10, 1), (10, 0), (10, 0))
    assert ad_app["prog"].stage_geometry() == ((1, 1), (1, 1))


# --------------------------------------------------------------------------
# Bit-match matrix: every partition == the monolithic single-core kernel
# --------------------------------------------------------------------------


@APPS
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_partitions_bitwise_match_monolith(app, m, double_buffer):
    prog, state, regs = app["prog"], app["state"], app["regs"]
    ref = app["mono"].run_blocked(state, regs, steps=STEPS, m=m, block_h=8,
                                  double_buffer=double_buffer)
    for spec in fusion_partitions(prog.nstages):
        out = prog.kernel(spec).run_blocked(
            state, regs, steps=STEPS, m=m, block_h=8,
            double_buffer=double_buffer)
        assert torch.equal(out, ref), (spec, m, double_buffer)


@APPS
def test_partitions_match_reference_path(app):
    """Every partition == the compiler's reference function (the
    CompiledCore.apply chain of the fused wrapper), bitwise."""
    prog, state, regs = app["prog"], app["state"], app["regs"]
    ref = prog.kernel("").reference(state, regs, m=STEPS)
    for spec in fusion_partitions(prog.nstages):
        out = prog.kernel(spec).run_blocked(state, regs, steps=STEPS, m=2,
                                            block_h=8)
        assert torch.equal(out, ref), spec


@APPS
def test_partitions_bitwise_match_sharded(app):
    """Each partition on a 2-shard ring of ``["cpu"] * 2`` equals one
    device (the JAX test needs forced host devices; the port's CPU mesh
    always runs)."""
    prog, state, regs = app["prog"], app["state"], app["regs"]
    for spec in fusion_partitions(prog.nstages):
        pk = prog.kernel(spec)
        one = pk.run_blocked(state, regs, steps=2, m=1, block_h=8, d=1)
        two = pk.run_blocked(state, regs, steps=2, m=1, block_h=8, d=2)
        assert torch.equal(one, two), spec


def test_unfused_baseline_does_round_trip(ad_app, monkeypatch):
    """The contrast path, by crossing count: ``run_unfused`` copies every
    cluster's output to the host once per step (on the CPU the copy is a
    no-op the device cannot show, so count the calls)."""
    prog, state, regs = ad_app["prog"], ad_app["state"], ad_app["regs"]
    pk = prog.kernel("1+1")
    crossings = []
    orig = torch.Tensor.cpu

    def spy(self, *args, **kwargs):
        crossings.append(tuple(self.shape))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    out = pk.run_unfused(state, regs, steps=2, block_h=8)
    monkeypatch.undo()
    # one host materialization per cluster per step
    assert len(crossings) >= 2 * len(pk.clusters)
    assert torch.equal(out, pk.run_blocked(state, regs, steps=2, m=1,
                                           block_h=8))


@pytest.mark.parametrize("which", ["lbm", "advdiff"])
def test_cluster_cores_lower_as_designed(lbm_app, ad_app, which):
    """Each cluster's generated kernel: the fused advection-diffusion
    cluster stencils its computed intermediate (two phases, ``a``
    materialized, reach (2, 2)); the uLBM clusters that start with
    collide+stream are the PE's layout and the boundary and moments
    stages read no neighbour (halo 0, one phase, state in registers).
    Every tap is printed as one shared load, none with a bounds check."""
    prog = lbm_app["prog"] if which == "lbm" else ad_app["prog"]
    pe = lbm_app["mono"].program
    for lo in range(prog.nstages):
        for hi in range(lo + 1, prog.nstages + 1):
            p = prog.cluster_kernel(lo, hi).program
            layout = (len(p.phases), p.K, p.halo, p.halo_x, p.reg_state,
                      p.in_place)
            if which == "advdiff":
                want = (2, 1, 2, 2, False, True) if (lo, hi) == (0, 2) \
                    else (1, 0, 1, 1, False, False)
            elif lo == 0:
                want = (len(pe.phases), pe.K, 1, 1, True, True)
            else:
                want = (1, 0, 0, 0, True, True)
            assert layout == want, (p.name, layout)
            src = p.cuda_source()
            assert "spd_tap(" not in src and f"HALO = {p.halo};" in src


# --------------------------------------------------------------------------
# Stencil-inference memoization per (core, incoming extents)
# --------------------------------------------------------------------------


def test_stencil_summary_memoized_per_incoming_extents(ad_app):
    from repro_torch.core.codegen import stencil_summary

    compiled = ad_app["prog"].stages[1].compiled  # ReactDiffuse2D
    plain = stencil_summary(compiled)
    shifted = stencil_summary(compiled, incoming=((1, 0),))
    assert plain.halo() == 1
    assert shifted.halo() == 2  # edge extent composes with the stencil
    # each variant is cached; asking again returns the same object
    assert stencil_summary(compiled) is plain
    assert stencil_summary(compiled, incoming=((1, 0),)) is shifted
    # the fused wrapper's kernel sees the composed reach end to end
    assert ad_app["prog"].cluster_kernel(0, 2).halo == 2


# --------------------------------------------------------------------------
# The fusion axis through sweep → search → executed points
# --------------------------------------------------------------------------


def test_fusion_axis_sweeps_and_executes(ad_app, tmp_path):
    from repro_torch.core.measure import MeasurementCache
    from repro_torch.core.search import EXECUTED_POINT_FIELDS, ExhaustiveSearch

    prog, state, regs = ad_app["prog"], ad_app["state"], ad_app["regs"]
    ex = prog.explorer(H * W, grid_w=W)
    sweep = ex.sweep_gpu(bh_values=(8, 16), m_values=(1, 2), d_values=(1,),
                         fusion_values=fusion_partitions(prog.nstages))
    assert sorted(set(map(str, sweep.data["fusion"]))) == ["1+1", "2"]
    cache = MeasurementCache(tmp_path / "mc.json")
    kw = dict(strategy=ExhaustiveSearch(k=8), reps=1, calibrate=False,
              cache=cache)
    res = ex.search(sweep, state, regs, **kw)
    executed = res.executed
    assert executed, "exhaustive search executed nothing"
    assert {e.fusion for e in executed} == {"2", "1+1"}
    for e in executed:
        assert tuple(e.as_dict().keys()) == EXECUTED_POINT_FIELDS
        assert e.as_dict()["fusion"] in ("2", "1+1") and e.interpret
    # The same plan under both partitions is timed twice: the fusion spec
    # is part of the cache key, and the repeat is served from the cache.
    plans = {}
    for e in executed:
        plans.setdefault((e.block_h, e.m, e.steps), set()).add(e.fusion)
    assert any(len(f) == 2 for f in plans.values())
    assert len(cache._data) == res.budget_spent > 0
    again = ex.search(sweep, state, regs, **kw)
    assert again.budget_spent == 0
    assert {e.fusion for e in again.executed if e.cached} == {"2", "1+1"}


def test_run_for_point_and_run_factory(lbm_app):
    """``run_for_point`` legalizes through the program's stage geometry
    and runs its plan; the search back end declines batched plans."""

    class Point:
        m, detail = 4, {"block_rows": 20, "fusion": "1+2"}

    prog, state, regs = lbm_app["prog"], lbm_app["state"], lbm_app["regs"]
    pk = prog.kernel("1+2")
    out, (bh, m, db) = pk.run_for_point(state, regs, point=Point(), steps=8)
    assert (bh, m) == (16, 4) and db
    assert torch.equal(out, pk.run_blocked(state, regs, steps=8, m=4,
                                           block_h=16))
    factory = program_run_factory(prog, state, regs)
    assert factory(4, 4, 8, 1, True, b=2, fusion="3") is None
    run = factory(4, 4, 8, 1, True, fusion="2+1")
    assert torch.equal(run(), lbm_app["mono"].run_blocked(
        state, regs, steps=4, m=4, block_h=8))


# --------------------------------------------------------------------------
# The GPU model's shared-memory rule, per cluster
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(16, 64), (4096, 4096)])
def test_smem_rule_is_every_clusters_tile(h, w):
    """On the program lattices the model's ``smem`` rule holds exactly
    where every cluster's ``StreamKernel.tile`` fits: each cluster at its
    own composed halo, planes and guard rows, at m when fused and 1 when
    pipelined. At 16×64 no other rule bites, so that is the model's
    feasible set; at 4096² the reference's VMEM budget (kept for plan
    parity) also refuses the largest fused stripes, and the feasible set
    is the tiles that fit within it."""
    from repro_torch.core.dse import GPUModel
    from repro_torch.core.legalize import VMEM_BYTES

    bhs, ms = (8, 16, 32, 64, 128, 256), (1, 2, 4, 8, 16, 32)
    model = GPUModel()
    for prog in (tlbm.lbm_program(w, device="cpu"),
                 AdvectionDiffusionSimulation(h, w, device="cpu").program):
        wl = prog.workload(h * w, w)
        for spec in fusion_partitions(prog.nstages):
            pk = prog.kernel(spec)
            data = model.evaluate_batch(wl, *np.meshgrid(bhs, ms,
                                                         indexing="ij"),
                                        fusion=spec)
            fits = np.zeros_like(data["feasible"])
            for i, bh in enumerate(bhs):
                for j, m in enumerate(ms):
                    try:
                        pk.tile(w, bh, m)
                        fits[i, j] = True
                    except ValueError:
                        pass
                    pt = model.evaluate(wl, bh, m, fusion=spec)
                    smem_ok = not any(x.startswith("smem")
                                      for x in pt.limits)
                    assert smem_ok == bool(fits[i, j]), (spec, bh, m)
            vmem_ok = data["vmem_bytes"] <= VMEM_BYTES
            assert np.array_equal(data["smem_bytes"] <= SMEM_BYTES, fits)
            assert np.array_equal(data["feasible"], fits & vmem_ok), spec
            if h == 16:
                assert vmem_ok.all()
            if prog.nstages == 3:
                # The fused program reaches both sides of the rule; each
                # pipelined cluster launches at m 1 and fits everywhere,
                # where one fused tile at the summed halo would not.
                assert fits.any() and not fits.all() if spec == "3" \
                    else fits.all(), spec


def test_smem_rule_needs_the_cluster_tiles():
    """A staged workload without its cluster tiles has no ``smem`` price:
    the model refuses it rather than guess a tile."""
    import dataclasses

    from repro_torch.core.dse import GPUModel

    wl = tlbm.lbm_program(W, device="cpu").workload(H * W, W)
    bare = dataclasses.replace(wl, cluster_tiles=())
    for spec in ("3", "1+1+1"):
        GPUModel().evaluate(wl, 8, 1, fusion=spec)  # priced
        with pytest.raises(ValueError, match="cluster_tiles"):
            GPUModel().evaluate(bare, 8, 1, fusion=spec)


# --------------------------------------------------------------------------
# The pipelined path's bookkeeping: the shared ring, captured launches
# --------------------------------------------------------------------------


def test_ring_is_shared_and_grown(lbm_app):
    """One ring per shape, dtype and device, grown to the largest ``k``
    and shared, buffer for buffer, by every partition's graphs."""
    prog, state = lbm_app["prog"], lbm_app["state"]
    two = prog.ring(state, 2)
    three = prog.ring(state, 3)
    assert len(two) == 2 and len(three) == 3
    assert all(a is b for a, b in zip(two, three))
    assert prog.ring(state, 2)[1] is three[1]
    other = prog.ring(state[:, :8], 2)
    assert other[0].shape == (state.shape[0], 8, state.shape[2])
    assert other[0] is not three[0]


def test_captured_launches_count_at_replay():
    """Inside ``recording()`` a launch is recorded for the graph's
    replays and counted nowhere; outside it counts once in the wrapper
    and once for its core."""
    from repro_torch.core.codegen import StripeProgram
    from repro_torch.kernels.spd_stream.spd_stream import count, recording
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_streamed as fn,
    )

    before = (fn.launches, StripeProgram.launches.get("toy_core", 0))
    with recording() as rec:
        count(fn, "toy_core")
        count(fn, "toy_core")
    assert rec == [(fn, "toy_core")] * 2
    assert (fn.launches, StripeProgram.launches.get("toy_core", 0)) == before
    for f, name in rec:
        count(f, name)
    assert fn.launches == before[0] + 2
    assert StripeProgram.launches["toy_core"] == before[1] + 2
    StripeProgram.launches.pop("toy_core")


def test_measure_salt_covers_the_program_layer():
    """A change to the program layer invalidates cached program timings,
    as in the reference's ``measure._SALT_MODULES``."""
    from repro_torch.core import measure

    assert "repro_torch.core.program" in measure._SALT_MODULES
