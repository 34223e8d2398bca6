"""The readers of the program's own counters, on synthetic readings.

The serving engine's tick split comes from ``SimEngine.stats()`` (the
reading's ``engine``), the set-up counters from ``repro_torch.tracing``
in the process. Each reader returns None on the other kind of cell and
where its counter is absent, as on a program without it.
"""

import sys

import pytest

from bench import harness

ENGINE = {"launches": 4000, "launch_wall_s": 5.0, "enqueue_s": 0.2,
          "dissolve_s": 1.5, "tick_s": 8.0, "member_steps": 32000,
          "occupancy": {"1": 4000}}
SERVE_METRICS = {
    "engine_enqueue_us.serve": 50.0,
    "engine_dissolve_share_pct.serve": 15.0,
    "engine_tick_host_share_pct.serve": 15.0,
}


def _reading(kind="serve", engine=None):
    return harness.Reading(kind=kind, frozen={}, peaks=None, cells=1,
                           window_s=10.0, engine=dict(engine or {}))


@pytest.mark.parametrize("metric", sorted(SERVE_METRICS))
def test_engine_reader_reads_the_tick_split(metric):
    read = harness.load_reader(metric)
    assert read(_reading(engine=ENGINE)) == pytest.approx(
        SERVE_METRICS[metric])
    assert read(_reading(kind="run", engine=ENGINE)) is None


@pytest.mark.parametrize("metric", sorted(SERVE_METRICS))
@pytest.mark.parametrize("missing", ["enqueue_s", "dissolve_s", "tick_s"])
def test_engine_reader_is_silent_without_its_counter(metric, missing):
    """An engine older than the counter (its stats without the key)
    yields no number."""
    engine = {k: v for k, v in ENGINE.items() if k != missing}
    value = harness.load_reader(metric)(_reading(engine=engine))
    needs = {"engine_enqueue_us.serve": {"enqueue_s"},
             "engine_dissolve_share_pct.serve": {"dissolve_s"},
             "engine_tick_host_share_pct.serve": {"tick_s", "dissolve_s"}}
    assert (value is None) == (missing in needs[metric])


def test_enqueue_reader_is_silent_without_launches():
    engine = {**ENGINE, "launches": 0}
    assert harness.load_reader("engine_enqueue_us.serve")(
        _reading(engine=engine)) is None


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "_COUNTERS", {"builds": 0})
    return tracing


@pytest.mark.parametrize("kind", ["run", "serve"])
def test_setup_readers_sum_the_program_counters(counters, kind):
    counters.add("setup.compile", 0.25)
    counters.add("setup.lower", 0.5)
    counters.add("setup.build", 6.0)
    counters.add("builds", 1)
    r = _reading(kind=kind)
    assert harness.load_reader("setup_program_s")(r) == pytest.approx(6.75)
    assert harness.load_reader("kernel_builds")(r) == 1


def test_setup_reader_is_silent_with_no_phase_timed(counters):
    r = _reading()
    assert harness.load_reader("setup_program_s")(r) is None
    assert harness.load_reader("kernel_builds")(r) == 0


@pytest.mark.parametrize("metric", ["setup_program_s", "kernel_builds"])
def test_setup_readers_are_silent_without_the_module(monkeypatch, metric):
    """A program without ``repro_torch.tracing`` yields no number."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert harness.load_reader(metric)(_reading()) is None
