"""The port's explorer against the JAX package's: Pareto masks, sweeps and
frontiers (exact), and the default back end, ``kernel_run_factory``,
whose runs are held to the JAX ``run_blocked`` (Pallas in interpret mode)
at rtol 2e-5 / atol 1e-6 — XLA and torch round the same op tree at the
same points, but multi-step runs compound last-bit differences.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro.core.dse import StreamWorkload as JWorkload
from repro.core.dse import TPUTarget
from repro.core.explorer import Explorer as JExplorer
from repro.core.explorer import pareto_mask as jpareto
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core.dse import GPUModel, GPUTarget, StreamWorkload
from repro_torch.core.explorer import Explorer, pareto_mask, render_executed
from repro_torch.core.search import kernel_run_factory

RTOL, ATOL = 2e-5, 1e-6


def tpu_constants() -> GPUTarget:
    return GPUTarget(**dataclasses.asdict(TPUTarget()))


def test_pareto_mask_equals_the_reference():
    rng = np.random.default_rng(0)
    for shape in ((40, 3), (200, 2), (7, 1), (30,)):
        x = rng.integers(0, 6, size=shape).astype(float)
        if x.ndim == 2 and x.shape[0] > 10:
            x[3, 0] = np.nan  # non-finite rows are never returned
            x[5, -1] = np.inf
        for maximize in (None, [True] * (x.shape[1] if x.ndim == 2 else 1),
                         ([True, False, True][:x.shape[1]]
                          if x.ndim == 2 else [False])):
            got = pareto_mask(x, maximize)
            assert np.array_equal(got, jpareto(x, maximize))
    assert not pareto_mask(np.full((3, 2), np.nan)).any()


def _toy_pair():
    pw = StreamWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64)
    jw = JWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64)
    return (Explorer(pw, gpu=GPUModel(tpu_constants())), JExplorer(jw))


def _pts(points):
    return [(p.n, p.m, p.detail.get("block_rows"), p.feasible,
             p.sustained_gflops, p.perf_per_watt, tuple(p.limits))
            for p in points]


@pytest.mark.parametrize("axes", [
    dict(d_values=(1,)),
    dict(d_values=(1, 2, 4), dx_values=(1, 2)),
    dict(d_values=(1, 2), b_values=(1, 4), double_buffer=False),
])
def test_sweep_and_frontier_equal_the_reference(axes):
    port, ref = _toy_pair()
    kw = dict(bh_values=(8, 16, 32, 64), m_values=(1, 2, 4, 8), **axes)
    got, want = port.sweep_gpu(**kw), ref.sweep_tpu(**kw)
    assert len(got) == len(want)
    assert np.array_equal(got.pareto_mask(), want.pareto_mask())
    assert _pts(got.frontier()) == _pts(want.frontier())
    assert _pts(got.top(5)) == _pts(want.top(5))
    assert _pts([got.best()]) == _pts([want.best()])
    assert got.coord_names == want.coord_names
    assert port.sweep("gpu", **kw).target == "gpu"
    with pytest.raises(ValueError, match="want 'fpga' or 'gpu'"):
        port.sweep("tpu", **kw)


def test_fpga_sweep_from_a_compiled_core_equals_the_reference():
    core = tdif.compile_diffusion(64)
    jcore = jdif.compile_diffusion(64)
    got = core.explorer(64 * 64, grid_w=64).sweep_fpga()
    want = jcore.explorer(64 * 64, grid_w=64).sweep_fpga()
    assert got.table() == want.table()
    assert core.explorer(64 * 64, grid_w=64).core is core


@pytest.fixture(scope="module")
def apps():
    """(port kernel, port state, JAX kernel, JAX state, regs) at 64×64."""
    u0 = np.asarray(jdif.sine_init(64, 64)[0])
    u0 = u0 + 0.01 * np.random.default_rng(0).standard_normal((64, 64))
    u0 = u0.astype(np.float32)
    tdsim = tdif.DiffusionSimulation(64, 64, device="cpu")
    jdsim = jdif.DiffusionSimulation(64, 64)
    f, attr, _ = jlbm.taylor_green_init(64, 64)
    f, attr = np.asarray(f), np.asarray(attr)
    tlsim = tlbm.LBMSimulation(tlbm.LBMProblem(64, 64), device="cpu")
    jlsim = jlbm.LBMSimulation(jlbm.LBMProblem(64, 64))
    return {
        "diffusion": (tdsim.kernel, tdsim.state(u0), jdsim.kernel,
                      jdsim.state(u0), (0.2,), (16, 2)),
        "lbm": (tlsim.stream_kernel(), tlsim.stream_state(f, attr),
                jlsim.stream_kernel(), jlsim.stream_state(f, attr),
                tlsim.stream_regs(), (8, 4)),
    }


@pytest.mark.parametrize("app", ["diffusion", "lbm"])
def test_run_factory_output_equals_jax_run_blocked(apps, app):
    kern, state, jkern, jstate, regs, (bh, m) = apps[app]
    run = kernel_run_factory(kern, state, regs)(2 * m, m, bh, 1, True)
    want = jkern.run_blocked(jstate, regs, steps=2 * m, m=m, block_h=bh,
                             interpret=True)
    np.testing.assert_allclose(run().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_run_factory_shards_on_the_cpu_and_declines(apps):
    """d > 1 runs on the CPU d times and equals one device bitwise; a
    batch axis and a plan no tile fits are declined, never raised."""
    kern, state, *_ = apps["diffusion"]
    factory = kernel_run_factory(kern, state, (0.2,))
    one = factory(4, 2, 16, 1, True)()
    assert torch.equal(factory(4, 2, 16, 2, True)(), one)
    assert torch.equal(factory(4, 2, 16, 4, True, dx=2)(), one)
    assert factory(4, 2, 16, 1, True, b=2) is None
    assert factory(4, 2, 16, 2, False, b=4) is None
    assert factory(200, 100, 64, 1, True) is None  # (64+200)·2·201·4 B


def test_search_and_execute_frontier_on_the_cpu(apps):
    """The default back end through ``search`` and ``execute_frontier``:
    CPU states run the plain version (``interpret`` true, mode
    ``plain``); a declined point is counted and warned about."""
    state = apps["diffusion"][1]
    sim = tdif.DiffusionSimulation(64, 64, device="cpu")
    ex = sim.explorer()
    sweep = ex.sweep_gpu(bh_values=(8, 16), m_values=(1, 2),
                         d_values=(1, 2))
    res = ex.search(sweep, state, (0.2,), reps=1, calibrate=False,
                    max_devices=2)
    assert res.executed and all(e.interpret for e in res.executed)
    table = render_executed(res.executed)
    assert "| plain |" in table and "| gpu |" not in table
    ex_done = ex.execute_frontier(sweep, state, (0.2,), k=1, reps=1,
                                  calibrate=False)
    assert len(ex_done) == 1 and ex_done[0].d == 1
    huge = ex.sweep_gpu(bh_values=(64,), m_values=(100,), d_values=(1,))
    assert huge.feasible.tolist() == [False]  # the smem rule
    # A back end that cannot launch a feasible point declines it.
    with pytest.warns(RuntimeWarning, match="could not launch"):
        got = ex.execute_frontier(
            sweep, state, (0.2,), k=1, reps=1, calibrate=False,
            run_factory=lambda *a, **k: None, grid_shape=(64, 64),
            cache_tag="none", device="cpu")
    assert got == []


def test_search_needs_a_gpu_sweep_and_a_core():
    port, _ = _toy_pair()
    with pytest.raises(ValueError, match="GPU sweep"):
        port.search(port.sweep_fpga(), None)
    with pytest.raises(ValueError, match="compiled core"):
        port.search(port.sweep_gpu(d_values=(1,)), torch.zeros(1, 8, 8))
