"""The port's host spans and counters (``repro_torch.tracing``) on the CPU.

A span costs a flag check with no profiler active and names a host range
under one; the serving engine's tick, the set-up phases and the kernels'
builds are counted on the host clock. No test asserts a host-timed rate.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.apps import diffusion as dif
from repro_torch.kernels import build
from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"


def _program_spans() -> list[str]:
    """Every span name the port's sources open, read from the text."""
    names = set()
    for path in SRC.rglob("*.py"):
        names.update(re.findall(r"\b(?:span|timed)\(\"([^\"]+)\"\)",
                                path.read_text()))
    return sorted(names)


SPANS = _program_spans()


def _harness_spans() -> tuple:
    spec = importlib.util.spec_from_file_location(
        "bench_tracing", ROOT / "bench" / "tracing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPANS + (mod.WINDOW,)


def test_the_port_opens_the_engine_and_set_up_spans():
    assert {"sim.admit", "sim.form", "sim.enqueue", "sim.dissolve",
            "spd.launch", "stream.alloc", "setup.compile", "setup.lower",
            "setup.sweep", "setup.build", "setup.load"} <= set(SPANS)


@pytest.mark.parametrize("name", SPANS)
def test_span_names_keep_clear_of_the_harness_and_the_readers(name):
    """A program span is the program's: its prefix says so, no harness
    span has its name, and no kernel reader matches it."""
    assert name.split(".")[0] in ("sim", "spd", "stream", "setup")
    assert name not in _harness_spans()
    assert "spd_multistep_kernel" not in name


@pytest.mark.parametrize("name", SPANS)
def test_span_is_the_shared_null_context_without_a_profiler(name):
    assert tracing.span(name) is tracing.span("other") is tracing._NULL
    with tracing.span(name):
        pass


def test_span_opens_a_host_range_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("sim.admit") is not tracing._NULL
        with tracing.span("sim.admit"):
            torch.ones(4).add_(1)
    assert "sim.admit" in {e.name for e in prof.events()}


def _tenant(h=16, w=32):
    sim = dif.DiffusionSimulation(h, w, alpha=0.2, device="cpu")
    u0, _ = dif.sine_init(h, w, device="cpu")
    gen = torch.Generator().manual_seed(0)
    states = [sim.state(u0 + 0.01 * torch.randn(h, w, generator=gen))
              for _ in range(3)]
    return sim.kernel, states


def _drain(trace: bool):
    """A CPU engine at b 1, m 2 drained on three 8-step diffusion
    requests: each forms a width-1 cohort, launches four times and
    dissolves once. Returns the engine and the profiler's host events."""
    kern, states = _tenant()
    eng = SimEngine(PlanResolver(budget=0, b_values=(1,), bh_values=(8,),
                                 m_values=(2,)), device="cpu")
    for rid, st in enumerate(states):
        assert eng.submit(SimRequest(rid=rid, core=kern, state=st, steps=8,
                                     regs=(0.2,)))
    if not trace:
        assert len(eng.run_until_drained()) == 3
        return eng, []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(eng.run_until_drained()) == 3
    return eng, [e.name for e in prof.events()]


@pytest.fixture(scope="module")
def traced():
    return _drain(trace=True)


@pytest.mark.parametrize("name,count", [("sim.admit", 3), ("sim.form", 3),
                                        ("sim.enqueue", 12),
                                        ("sim.dissolve", 3)])
def test_a_traced_engine_emits_its_tick_spans(traced, name, count):
    _, names = traced
    assert names.count(name) == count


@pytest.mark.parametrize("trace", [False, True])
def test_engine_stats_split_the_tick(trace):
    eng, _ = _drain(trace)
    s = eng.stats()
    assert s["launches"] == 12
    assert s["tick_s"] >= s["launch_wall_s"] + s["dissolve_s"]
    assert s["launch_wall_s"] >= s["enqueue_s"] > 0
    assert s["dissolve_s"] > 0
    assert s["dissolve_s"] >= s["wait_s"]
    eng.reset_counters()
    s = eng.stats()
    assert s["enqueue_s"] == s["dissolve_s"] == s["tick_s"] == 0.0
    assert s["wait_s"] == 0.0


@pytest.mark.parametrize("name", ["setup.parse", "setup.compile",
                                  "setup.lower", "setup.sweep"])
def test_building_an_app_counts_its_set_up(name):
    before = tracing.snapshot().get(name, 0.0)
    sim = dif.DiffusionSimulation(16, 32, alpha=0.2, device="cpu")
    sim.explorer().sweep_gpu(bh_values=(8,), m_values=(1, 2),
                             d_values=(1,))
    assert tracing.snapshot()[name] > before


class _Point:
    def __init__(self, block_h, m):
        self.m = m
        self.detail = {"block_rows": block_h}


@pytest.mark.parametrize("dx", [0, 1, 2])
def test_run_for_point_counts_its_plans_recompute(monkeypatch, dx):
    """``run_for_point`` adds once a run what its launches execute and
    keep: on one card (``dx`` 0) and on a (4 / dx, dx) mesh of four CPU
    shards, the ratio is the GPU model's recompute at the same point."""
    from repro_torch.core.dse import GPUModel

    monkeypatch.setattr(tracing, "_COUNTERS", {"builds": 0})
    h, w = 32, 128
    sim = dif.DiffusionSimulation(h, w, alpha=0.2, device="cpu")
    kern = sim.kernel if not dx else sim.kernel.sharded(4, ["cpu"] * 4,
                                                        dx=dx)
    state = torch.rand((1, h, w), generator=torch.Generator().manual_seed(3))
    kern.run_for_point(state, (0.2,), point=_Point(8, 2), steps=8)
    kern.run_for_point(state, (0.2,), point=_Point(8, 2), steps=4)
    counts = tracing.snapshot()
    assert counts["plan.useful_cell_steps"] == h * w * 12
    p = GPUModel().evaluate(sim.explorer().workload, 8, 2,
                            d=4 if dx else 1, dx=max(dx, 1))
    assert (counts["plan.executed_cell_steps"]
            / counts["plan.useful_cell_steps"]) == pytest.approx(
        1 / p.detail["halo_useful_fraction"])


def test_timed_counts_its_seconds_under_its_span(monkeypatch):
    monkeypatch.setattr(tracing, "_COUNTERS", {"builds": 0})
    ticks = iter([1.0, 3.5, 4.0, 4.25])
    monkeypatch.setattr(tracing, "perf_counter", lambda: next(ticks))
    with tracing.timed("setup.lower"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.timed("setup.lower"):
            pass
    assert tracing.snapshot() == {"builds": 0, "setup.lower": 2.75}
    assert "setup.lower" in {e.name for e in prof.events()}


def test_builds_count_nvcc_runs_only(monkeypatch, tmp_path):
    """A library already built starts no ``nvcc`` and counts nothing; one
    that is not counts one run."""
    started = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_text("")

        def communicate(self):
            return "", None

    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_LIBS", {})
    before = tracing.snapshot()
    build.load("spd_probe", "// probe\n")
    mid = tracing.snapshot()
    assert len(started) == 1 and mid["builds"] == before["builds"] + 1
    assert mid["setup.build"] >= before.get("setup.build", 0.0)
    assert mid["setup.load"] >= before.get("setup.load", 0.0)
    build.load("spd_probe", "// probe\n")
    assert len(started) == 1
    assert tracing.snapshot()["builds"] == mid["builds"]


@pytest.mark.cuda
def test_a_cached_library_builds_nothing_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    u0, _ = dif.sine_init(64, 128, device="cuda")
    first = dif.DiffusionSimulation(64, 128, alpha=0.2, device="cuda")
    first.kernel(first.state(u0), (0.2,), m=2, block_h=16)
    builds = tracing.snapshot()["builds"]
    again = dif.DiffusionSimulation(64, 128, alpha=0.2, device="cuda")
    again.kernel(again.state(u0), (0.2,), m=2, block_h=16)
    torch.cuda.synchronize()
    assert tracing.snapshot()["builds"] == builds


@pytest.mark.cuda
def test_the_card_launch_spans_under_a_profiler():
    """``run_blocked`` on the card: one ``stream.alloc`` for its pair of
    buffers and one ``spd.launch`` a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    sim = dif.DiffusionSimulation(64, 128, alpha=0.2, device="cuda")
    u0, _ = dif.sine_init(64, 128, device="cuda")
    st = sim.state(u0)
    sim.kernel.run_blocked(st, (0.2,), steps=4, m=2, block_h=16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.kernel.run_blocked(st, (0.2,), steps=8, m=2, block_h=16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("stream.alloc") == 1
    assert names.count("spd.launch") == 4
