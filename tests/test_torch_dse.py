"""The port's design-space models against the JAX package's.

``FPGAModel`` is a copy: its batched lattice equals the reference's
exactly. ``GPUModel`` keeps the reference ``TPUModel``'s equations: built
with the reference ``TPUTarget``'s constants it equals
``TPUModel.evaluate_batch`` exactly on a lattice where every Hopper tile
fits, and adds one rule of its own, the ``smem`` limit (docs/port.md
§dse), which agrees with the legalizer's ``launch_tile``. All
comparisons are exact (numpy on both sides, equal arrays).
"""

import dataclasses

import numpy as np
import pytest

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro.core.dse import FPGAModel as JFPGAModel
from repro.core.dse import StreamWorkload as JWorkload
from repro.core.dse import TPUModel, TPUTarget
from repro.core.dse import render_table as jrender
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core.dse import (
    FPGAModel,
    GPUModel,
    GPUTarget,
    StreamWorkload,
    render_table,
)
from repro_torch.core.legalize import SMEM_BYTES, launch_tile
from repro_torch.core.measure import BackendCalibration

N_VALUES = M_VALUES = (1, 2, 4, 8)


def tpu_constants() -> GPUTarget:
    return GPUTarget(**dataclasses.asdict(TPUTarget()))


def _common(w) -> dict:
    """A workload's fields that the reference has."""
    names = [f.name for f in dataclasses.fields(JWorkload)]
    return {n: getattr(w, n) for n in names}


@pytest.fixture(scope="module")
def paper_pe():
    port = tlbm.LBMSimulation(tlbm.LBMProblem(300, 720), device="cpu")
    ref = jlbm.LBMSimulation(jlbm.LBMProblem(300, 720))
    return port, ref


def _assert_batch_equal(got: dict, want: dict, keys=None):
    keys = keys if keys is not None else want.keys()
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_workload_and_report_equal_the_reference(paper_pe):
    port, ref = paper_pe
    assert _common(port.stream_workload()) == dataclasses.asdict(
        ref.stream_workload())
    w = port.pe.hardware_report.workload(300 * 720, grid_w=720)
    assert dataclasses.asdict(w) == {**dataclasses.asdict(
        ref.hardware_report.workload(300 * 720, grid_w=720)),
        "tile_planes": 0, "tile_guard_rows": 0}
    # the explorer's workload carries the generated kernel's Hopper tile
    assert port.stream_workload().tile_planes == 19
    assert port.stream_workload().tile_guard_rows == 4


def test_fpga_lattice_equals_the_reference_and_picks_1_4(paper_pe):
    port, ref = paper_pe
    n, m = np.meshgrid(N_VALUES, M_VALUES, indexing="ij")
    census = port.hardware_report.census
    assert census == ref.hardware_report.census
    got = FPGAModel().evaluate_batch(port.stream_workload(), n.ravel(),
                                     m.ravel(), census)
    want = JFPGAModel().evaluate_batch(ref.stream_workload(), n.ravel(),
                                       m.ravel(), census)
    _assert_batch_equal(got, want)
    assert FPGAModel().power_r2 == JFPGAModel().power_r2
    sweep = port.explorer().sweep_fpga(n_values=N_VALUES,
                                       m_values=M_VALUES)
    best = sweep.best("perf_per_watt")
    assert (best.n, best.m) == (1, 4)
    jbest = ref.explorer().sweep_fpga(n_values=N_VALUES,
                                      m_values=M_VALUES).best("perf_per_watt")
    assert (best.perf_per_watt, best.limits) == (jbest.perf_per_watt,
                                                 jbest.limits)


@pytest.mark.parametrize("app", ["toy", "lbm", "diffusion"])
def test_gpu_model_at_tpu_constants_equals_tpu_model(app):
    """Batched and scalar paths, with the device, mesh and batch axes."""
    if app == "toy":
        pw = StreamWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64,
                            halo=1)
        jw = JWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64,
                       halo=1)
    elif app == "lbm":
        pw = tlbm.LBMSimulation(tlbm.LBMProblem(64, 64),
                                device="cpu").stream_workload()
        jw = jlbm.LBMSimulation(jlbm.LBMProblem(64, 64)).stream_workload()
    else:
        pw = tdif.DiffusionSimulation(64, 64, device="cpu").explorer().workload
        jw = jdif.DiffusionSimulation(64, 64).explorer().workload
    bh, m, d, b, dx = (a.ravel() for a in np.meshgrid(
        (8, 16, 32, 64), (1, 2, 4, 8), (1, 2, 4), (1, 2), (1, 2),
        indexing="ij"))
    model = GPUModel(tpu_constants())
    got = model.evaluate_batch(pw, bh, m, d=d, b=b, dx=dx)
    want = TPUModel().evaluate_batch(jw, bh, m, d=d, b=b, dx=dx)
    assert (got["smem_bytes"] <= SMEM_BYTES).all()  # every tile fits
    _assert_batch_equal(got, want)
    for i in range(0, bh.size, 7):
        p = model.evaluate(pw, int(bh[i]), int(m[i]), d=int(d[i]),
                           b=int(b[i]), dx=int(dx[i]))
        q = TPUModel().evaluate(jw, int(bh[i]), int(m[i]), d=int(d[i]),
                                b=int(b[i]), dx=int(dx[i]))
        assert (p.feasible, p.limits, p.sustained_gflops, p.power_w) == (
            q.feasible, q.limits, q.sustained_gflops, q.power_w)
        assert p.feasible == bool(got["feasible"][i])
        assert render_table([p]) == jrender([q])


def test_smem_limit_marks_the_8192_diffusion_point_infeasible():
    """Diffusion 8192², block_h 2048, m 8: the reference's budget takes it
    single-buffered, no Hopper tile does."""
    sim = tdif.DiffusionSimulation(8192, 8192, device="cpu")
    w = sim.explorer().workload
    p = GPUModel().evaluate(w, 2048, 8, double_buffer=False)
    need = (2048 + 16) * 2 + 4  # two planes of the stripe + guard rows
    assert not p.feasible
    assert f"smem {need * 17 * 4}>{SMEM_BYTES}" in p.limits
    assert not any(x.startswith("VMEM") for x in p.limits)
    q = TPUModel().evaluate(
        jdif.DiffusionSimulation(64, 8192).core.stream_workload(
            8192 * 8192, 8192), 2048, 8, double_buffer=False)
    assert q.feasible  # the reference's model accepts it
    with pytest.raises(ValueError, match="no column tile fits"):
        sim.kernel.tile(8192, 2048, 8, double_buffer=False)
    batch = GPUModel().evaluate_batch(w, np.array([2048, 32]),
                                      np.array([8, 4]), double_buffer=False)
    assert batch["feasible"].tolist() == [False, True]


@pytest.mark.parametrize("app", ["lbm", "diffusion"])
def test_smem_rule_agrees_with_launch_tile(app):
    """A point passes the smem rule exactly when the legalizer's
    launch_tile finds a tile for the generated kernel."""
    if app == "lbm":
        sim = tlbm.LBMSimulation(tlbm.LBMProblem(64, 256), device="cpu")
        w, prog = sim.stream_workload(), sim.stream_kernel().program
    else:
        sim = tdif.DiffusionSimulation(64, 256, device="cpu")
        w, prog = sim.explorer().workload, sim.kernel.program
    bhs, ms = np.meshgrid((8, 64, 256, 512, 1024, 4096),
                          (1, 4, 8, 16, 32), indexing="ij")
    batch = GPUModel().evaluate_batch(w, bhs.ravel(), ms.ravel())
    for i, (bh, m) in enumerate(zip(bhs.ravel(), ms.ravel())):
        try:
            launch_tile(256, int(bh), int(m), halo=prog.halo,
                        halo_x=prog.halo_x,
                        planes=lambda db: prog.launch_planes(
                            streamed=True, double_buffer=db),
                        guard_rows=prog.guard_rows)
            fits = True
        except ValueError:
            fits = False
        assert fits == bool(batch["smem_bytes"][i] <= SMEM_BYTES), (bh, m)
        scalar = GPUModel().evaluate(w, int(bh), int(m))
        assert (any(x.startswith("smem") for x in scalar.limits)
                == (not fits))


def test_gpu_target_is_the_h100_data_sheet():
    t = GPUTarget()
    assert (t.hbm_gbs, t.vpu_f32_tflops, t.peak_bf16_tflops) == (
        3350.0, 67.0, 989.0)
    assert (t.hbm_bytes_per_chip, t.chip_peak_w) == (80 * 10**9, 700.0)
    assert t.smem_bytes == SMEM_BYTES and t.launch_overhead_s == 0.0
    assert set(dataclasses.asdict(TPUTarget())) < set(dataclasses.asdict(t))


def test_calibrated_model_equals_the_reference():
    """A calibration folds into the target as in the reference: compute
    aggregate/d, bandwidth per device unless the devices share one host
    (the CPU)."""
    from repro.core.measure import BackendCalibration as JCal

    w = StreamWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64)
    jw = JWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64)
    for interpret, backend, jbackend in ((True, "cpu/x86_64", "cpu"),
                                         (False, "cuda/H100", "tpu")):
        cal = BackendCalibration(backend, interpret, 12.5, 30.0,
                                 by_d=((1, 12.5), (2, 20.0)))
        jcal = JCal(jbackend, interpret, 12.5, 30.0,
                    by_d=((1, 12.5), (2, 20.0)))
        for d in (1, 2, 4):
            got = cal.target(d, base=tpu_constants())
            want = jcal.target(d)
            assert (got.vpu_f32_tflops, got.hbm_gbs) == (
                want.vpu_f32_tflops, want.hbm_gbs)
            p = cal.model(d, base=tpu_constants()).evaluate(w, 16, 4, d=d)
            q = jcal.model(d).evaluate(jw, 16, 4, d=d)
            assert p.sustained_gflops == q.sustained_gflops
        assert GPUModel.calibrated(cal).target.name.startswith("h100-sxm+")
