"""The port's measurement harness, cache and calibration.

``time_run`` is held to its contract with a fake clock and a counting
``block`` (no host timing is asserted); fingerprints, cache keys and the
calibration arithmetic are held to the JAX package's ``core/measure.py``
on the same inputs, exactly.
"""

import json
import math

import pytest
import torch

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro.core import measure as jmeasure
from repro.core.compiler import Registry as JRegistry
from repro.core.dse import StreamWorkload as JWorkload
from repro.core.spd import parse_spd as jparse
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.core import measure
from repro_torch.core.dse import StreamWorkload
from repro_torch.core.measure import (
    MeasurementCache,
    Timing,
    block_until_ready,
    core_fingerprint,
    measured_run,
    time_run,
)


class FakeClock:
    """``perf_counter`` that moves only when a run says so."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_time_run_validates_its_arguments():
    with pytest.raises(ValueError, match="reps"):
        time_run(lambda: None, reps=0)
    with pytest.raises(ValueError, match="warmup"):
        time_run(lambda: None, warmup=-1)


def test_time_run_blocks_every_rep_inside_its_bracket(monkeypatch):
    """Every call — warm-up and rep — is followed by its own ``block``
    before the next call starts; the clock is read around each rep; the
    wall is the median rep, the warm-up never counted."""
    clock = FakeClock()
    monkeypatch.setattr(measure.time, "perf_counter", clock)
    durations = iter([8.0, 0.75, 0.25, 0.5])  # warm-up, then three reps
    events = []

    def fn():
        events.append("call")
        clock.now += next(durations)
        return len(events)

    def block(x):
        events.append(("block", x))
        return x

    t = time_run(fn, reps=3, warmup=1, block=block)
    assert events == ["call", ("block", 1), "call", ("block", 3),
                      "call", ("block", 5), "call", ("block", 7)]
    assert t.overhead_s == 0.0  # the fake clock never moves by itself
    assert t.times_s == (0.75, 0.25, 0.5)
    assert t.wall_s == 0.5 and t.reps == 3 and t.warmup == 1
    assert isinstance(t, Timing) and t.total_s == 1.5


def test_default_block_is_a_no_op_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    x = (torch.zeros(2), [torch.ones(1)], {"a": torch.zeros(3)})
    assert block_until_ready(x) is x
    assert block_until_ready(None) is None
    time_run(lambda: torch.zeros(4), reps=2, warmup=1)
    assert calls == []


def test_backend_descriptor_names_the_platform():
    assert measure.backend_descriptor("cpu").startswith("cpu/")
    assert measure.backend_descriptor(torch.device("cpu")) == \
        measure.backend_descriptor("cpu")


FMA_SPD = measure._fma_chain_spd(32)


@pytest.mark.parametrize("app", ["lbm", "diffusion", "fma"])
def test_core_fingerprints_equal_the_reference(app):
    if app == "lbm":
        port = tlbm.LBMSimulation(tlbm.LBMProblem(32, 64), device="cpu").pe
        ref = jlbm.LBMSimulation(jlbm.LBMProblem(32, 64)).pe
    elif app == "diffusion":
        port = tdif.DiffusionSimulation(32, 64, device="cpu").kernel
        ref = jdif.DiffusionSimulation(32, 64).kernel
    else:
        assert FMA_SPD == jmeasure._fma_chain_spd(32)
        port = measure.fma_chain_kernel(32, "cpu")
        ref = JRegistry().compile(jparse(FMA_SPD))
    assert core_fingerprint(port) == core_fingerprint(ref.core
                                                      if app == "fma"
                                                      else ref)
    assert core_fingerprint(port) == jmeasure.core_fingerprint(ref)
    assert core_fingerprint("lbm_stream") == "tag:lbm_stream"


def test_fma_chain_kernel_shape():
    """Halo 0, one state plane, one register: the m·halo == 0 walk."""
    kern = measure.fma_chain_kernel(32, "cpu")
    assert (kern.halo, kern.halo_x) == (0, 0)
    assert len(kern.compiled.core.regs) == 1
    assert kern.compiled.hardware_report.flops == 64
    state = torch.full((1, 16, 32), 0.5)
    out = kern.run_blocked(state, (0.997,), steps=2, m=2, block_h=8)
    assert torch.equal(out, kern.reference(state, (0.997,), m=2))


def test_cache_keys_cover_what_a_measurement_depends_on():
    base = ("spd:abc", (64, 64), (16, 4, 4, 1, 1), "cpu/x", True, 3, 1)
    key = MeasurementCache.make_key(*base)
    for i, alt in enumerate(["spd:abd", (64, 32), (16, 4, 4, 1, 0),
                             "cuda/NVIDIA H100 80GB HBM3", False, 5, 2]):
        other = list(base)
        other[i] = alt
        assert MeasurementCache.make_key(*other) != key
    assert MeasurementCache.make_key(*base) == key
    # the port's salt is its own: torch, its modules, csrc, nvcc flags
    assert measure.code_salt() != jmeasure.code_salt()
    assert len(measure.code_salt()) == 12


def test_code_salt_covers_every_kernel_source(monkeypatch):
    """A change to any file of ``csrc/`` changes the salt."""
    from repro_torch.kernels import build

    salt = measure.code_salt()
    real = type(build.CSRC).read_bytes

    def edited(path):
        data = real(path)
        return data + b"//" if path.name == "tile_copy.cuh" else data

    monkeypatch.setattr(measure, "_CODE_SALT", [])
    monkeypatch.setattr(type(build.CSRC), "read_bytes", edited)
    assert measure.code_salt() != salt


def test_cache_roundtrip_merge_and_stats(tmp_path):
    path = tmp_path / "sub" / "cache.json"
    a = MeasurementCache(path)
    assert a.get("k1") is None and a.stats()["misses"] == 1
    a.put("k1", {"wall_s": 1.5})
    b = MeasurementCache(path)
    b.put("k2", {"wall_s": 2.5})
    a.put("k3", {"wall_s": 3.5})  # re-merges b's entry first
    data = json.loads(path.read_text())
    assert set(data) == {"k1", "k2", "k3"}
    assert MeasurementCache(path).peek("k2") == {"wall_s": 2.5}
    c = MeasurementCache(path)
    assert c.get("k1")["wall_s"] == 1.5 and c.hits == 1
    assert measure.resolve_cache(None) is None
    assert measure.resolve_cache(False) is None
    assert measure.resolve_cache(c) is c
    assert measure.resolve_cache(str(path)).path == str(path)


def test_measured_run_serves_repeats_from_the_cache(tmp_path):
    cache = MeasurementCache(tmp_path / "c.json")
    calls = []
    run = lambda: calls.append(1)  # noqa: E731
    wall, cached = measured_run(run, key="k", cache=cache, reps=2, warmup=1)
    assert not cached and len(calls) == 3
    wall2, cached2 = measured_run(run, key="k", cache=cache, reps=2)
    assert cached2 and wall2 == wall and len(calls) == 3


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_MEASURE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_MEASURE_CACHE", raising=False)
    path = measure.default_cache_path()
    assert path.endswith("build/repro_torch/measure-cache.json")
    assert path != jmeasure.default_cache_path()
    monkeypatch.setenv("REPRO_MEASURE_CACHE", "/jax/cache.json")
    assert measure.default_cache_path() == path
    monkeypatch.setenv("REPRO_TORCH_MEASURE_CACHE", "/port/cache.json")
    assert measure.default_cache_path() == "/port/cache.json"


def test_probes_run_on_the_cpu_and_size_beyond_l2():
    """The probes run (their rates are host-timed, so only finiteness is
    checked); the card's bandwidth buffer is 1 GiB, past the 50 MB L2."""
    assert measure.PROBE_MBYTES["cuda"] * 2**20 > 50e6 * 10
    bw = measure.measure_memory_bandwidth_gbs(1, device="cpu", reps=1,
                                              memo=False)
    gf = measure.measure_elementwise_gflops("cpu", chain=4, shape=(16, 32),
                                            reps=1)
    assert math.isfinite(bw) and bw > 0 and math.isfinite(gf) and gf > 0
    cal = measure.calibrate_backend("cpu", chain=4, shape=(16, 32),
                                    mem_mbytes=1, reps=1)
    assert cal.interpret and cal.backend.startswith("cpu/")
    assert cal.by_d == ((1, cal.elem_gflops),)
    if not torch.cuda.is_available():  # the probes never fall back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure.measure_elementwise_gflops("cuda")


def test_calibrate_execution_equals_the_reference(monkeypatch):
    """The same probe walls give the same anchors: probes legalize as
    frontier points, dedupe after legalization, count recomputed halo
    sites, and anchor at the geometric mean; a declined probe is
    skipped, and no runnable probe raises."""
    walls = {}

    def fake_time_run(run, reps=3, warmup=1):
        wall = run()
        return Timing(wall, (wall,) * reps, reps, warmup, 0.0)

    monkeypatch.setattr(measure, "time_run", fake_time_run)
    monkeypatch.setattr(jmeasure, "time_run", fake_time_run)

    def factory(nsteps, m, block_h, d, double_buffer=True):
        walls[(block_h, m, d)] = 1e-3 * m * (1 + block_h / 64)
        return lambda: walls[(block_h, m, d)]

    kw = dict(grid_shape=(256, 128), halo=1, width=128, words=10,
              d_values=(1, 2), mem_gbs=100.0)
    pw = StreamWorkload("lbm", 131, 10, 10, 263, 0, 256 * 128, grid_w=128)
    jw = JWorkload("lbm", 131, 10, 10, 263, 0, 256 * 128, grid_w=128)
    got = measure.calibrate_execution(factory, workload=pw, device="cpu",
                                      **kw)
    want = jmeasure.calibrate_execution(factory, workload=jw, **kw)
    assert (got.elem_gflops, got.by_d, got.mem_gbs) == (
        want.elem_gflops, want.by_d, want.mem_gbs)
    assert got.interpret and got.detail == want.detail

    def declines_m8(nsteps, m, block_h, d, double_buffer=True):
        return None if m == 8 else factory(nsteps, m, block_h, d)

    one = measure.calibrate_execution(declines_m8, workload=pw,
                                      device="cpu", **kw)
    assert one.by_d[0][1] == pytest.approx(
        256 * 128 * 4 * 131 / (16 / 24) / walls[(16, 4, 1)] / 1e9)
    with pytest.raises(ValueError, match="no runnable probe"):
        measure.calibrate_execution(lambda *a, **k: None, workload=pw,
                                    device="cpu", **kw)
