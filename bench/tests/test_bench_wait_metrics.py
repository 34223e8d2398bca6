"""The readers of the serving engine's waits on the card, on synthetic
readings: ``waits`` and ``wait_s`` of ``SimEngine.stats()`` (the reading's
``engine``). Each returns None on a run cell and where its counter is
absent, as on an engine without it.
"""

import pytest

from bench import harness

ENGINE = {"launches": 4000, "launch_wall_s": 0.2, "enqueue_s": 0.2,
          "dissolve_s": 1.5, "tick_s": 8.0, "member_steps": 32000,
          "waits": 100, "wait_s": 0.9, "occupancy": {"1": 4000}}
WAIT_METRICS = {
    "engine_waits_per_launch.serve": 0.025,
    "engine_wait_share_pct.serve": 9.0,
}
NEEDS = {"engine_waits_per_launch.serve": "waits",
         "engine_wait_share_pct.serve": "wait_s"}


def _reading(kind="serve", engine=None):
    return harness.Reading(kind=kind, frozen={}, peaks=None, cells=1,
                           window_s=10.0, engine=dict(engine or {}))


@pytest.mark.parametrize("metric", sorted(WAIT_METRICS))
def test_wait_reader_reads_the_engines_waits(metric):
    read = harness.load_reader(metric)
    assert read(_reading(engine=ENGINE)) == pytest.approx(
        WAIT_METRICS[metric])
    assert read(_reading(kind="run", engine=ENGINE)) is None


@pytest.mark.parametrize("metric", sorted(WAIT_METRICS))
@pytest.mark.parametrize("missing", ["waits", "wait_s"])
def test_wait_reader_is_silent_without_its_counter(metric, missing):
    """An engine older than the counter (its stats without the key), as
    the parent's, yields no number."""
    engine = {k: v for k, v in ENGINE.items() if k != missing}
    value = harness.load_reader(metric)(_reading(engine=engine))
    assert (value is None) == (missing == NEEDS[metric])


def test_waits_reader_is_silent_without_launches():
    engine = {**ENGINE, "launches": 0}
    assert harness.load_reader("engine_waits_per_launch.serve")(
        _reading(engine=engine)) is None


def test_wait_readers_read_zero_on_an_engine_that_never_waited():
    engine = {**ENGINE, "waits": 0, "wait_s": 0.0}
    for metric in WAIT_METRICS:
        assert harness.load_reader(metric)(_reading(engine=engine)) == 0.0
