"""The reader of the plan's recompute, ``plan_recompute_x.run``, on
synthetic readings: the program's ``plan.*`` counters in the process,
None on another kind of cell or on a program without the counters."""

import pytest

from bench import harness


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "_COUNTERS", {"builds": 0})
    return tracing


def _reading(kind):
    return harness.Reading(kind=kind, frozen={}, peaks=None, cells=1,
                           window_s=10.0)


def test_reader_divides_executed_by_useful(counters):
    counters.add("plan.executed_cell_steps", 3_000)
    counters.add("plan.useful_cell_steps", 1_000)
    counters.add("plan.executed_cell_steps", 1_500)
    counters.add("plan.useful_cell_steps", 500)
    read = harness.load_reader("plan_recompute_x.run")
    assert read(_reading("run")) == pytest.approx(3.0)
    assert read(_reading("serve")) is None


def test_reader_is_silent_without_the_counters(counters):
    assert harness.load_reader("plan_recompute_x.run")(_reading("run")) is None


def test_a_run_cell_reads_its_plans_recompute(counters):
    """A traced run cell on the CPU, at a small grid, reports the metric
    above 1 (every launch recomputes halo rows and guard columns)."""
    out = harness.run_cell(
        "diffusion-8192.run", 2**31 + 9, 0.2, True, device="cpu",
        overrides={"grid": [64, 64], "steps_per_simulation": 8},
        log=lambda msg: None)
    value = out["result"]["metrics"]["plan_recompute_x.run"]
    assert value["unit"] == "x" and value["value"] > 1.0
