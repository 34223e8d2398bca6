"""The benchmark's files and arithmetic, on the CPU."""

import json
import math
import re

import numpy as np
import pytest

from bench import harness, loads, roofline, tracing

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
#: The numbers each kind of cell compares, each with a limit.
COMPARED = {"run": {"max_abs_gap"}, "serve": {"max_abs_gap"},
            "train": {"loss_rel_gap", "grad_norm_gap", "update_norm_gap"}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("bench/configs/")
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.find_cell(name)
    assert (harness.ROOT / cell.config["reference"]).exists()
    assert cell.config["name"] == cell.entry["config"]
    __import__(f"bench.apps.{cell.config['app']}")
    assert cell.mix["kind"] in COMPARED
    assert set(cell.limits) == COMPARED[cell.mix["kind"]]
    assert all(lim["limit"] > 0 for lim in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("config", [
    c["name"] for c in SPEC["configs"]
    if "plan_lattice" in harness.read_json(harness.ROOT / c["file"])])
def test_frozen_counts_match_the_census(config):
    """The frozen flops are the core's census; the planes its state's
    (every stream configuration; a training one's counts are held in
    ``test_bench_train.py``)."""
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    cfg = harness.read_json(harness.ROOT / entry["file"])
    app = __import__(f"bench.apps.{cfg['app']}", fromlist=["build"])
    system = app.build(cfg, (16, 32), "cpu")
    census = system.sim.hardware_report.census
    frozen = cfg["frozen"]
    assert sum(census.values()) == frozen["flops_per_update"]
    planes = system.kernel.program.P
    assert planes == frozen["planes_read"] == frozen["planes_written"]
    assert planes == app.PLANES


def test_roofline_arithmetic():
    peaks = roofline.PEAKS["H100"]
    lbm = {"flops_per_update": 131, "planes_read": 10, "planes_written": 10,
           "bytes_per_word": 4}
    dif = {"flops_per_update": 7, "planes_read": 1, "planes_written": 1,
           "bytes_per_word": 4}
    cells = 4096 * 4096
    assert roofline.launch_bytes(lbm, cells) == 20 * 4 * cells
    assert roofline.bound_s(lbm, peaks, cells, members=1, member_steps=8) \
        == pytest.approx(1.342177e9 / 3.35e12)
    # m 16 makes the PE's launch bound by its operations
    assert roofline.bound_s(lbm, peaks, cells, members=1, member_steps=16) \
        == pytest.approx(131 * 16 * cells / 67e12)
    assert roofline.bound_s(dif, peaks, 8192 * 8192, members=1,
                            member_steps=8) == pytest.approx(5.368709e8
                                                             / 3.35e12)
    assert roofline.mfu_pct(lbm, peaks, 33_000 * 10**6, 1.0) == \
        pytest.approx(100 * 131 * 33e9 / 67e12)
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is peaks
    with pytest.raises(KeyError):
        roofline.peaks_for("cpu")


def _reading(**kw):
    base = dict(kind="run", frozen={"flops_per_update": 131,
                                    "planes_read": 10, "planes_written": 10,
                                    "bytes_per_word": 4},
                peaks=roofline.PEAKS["H100"], cells=4096 * 4096,
                window_s=10.0, updates=8 * 1000 * 4096 * 4096,
                launches=1000, plan={"m": 8})
    base.update(kw)
    return harness.Reading(**base)


def test_readers():
    trace = {"window_s": 10.0, "busy_s": 9.9, "kernels": {
        "spd_multistep_kernel<false>": (1000, 4.2), "Memcpy DtoH": (3, 0.1)}}
    r = _reading(trace=trace)
    bound = 1000 * 1.342177e9 / 3.35e12
    read = harness.load_reader
    assert read("spd_multistep_roofline.run")(r) == pytest.approx(
        100 * bound / 4.2)
    assert read("device_idle_pct.run")(r) == pytest.approx(1.0)
    assert read("steps_per_launch.run")(r) == 8
    assert read("mfu_pct.run")(r) == pytest.approx(
        100 * 131 * r.updates / 10 / 67e12)
    assert read("mfu_pct.serve")(r) is None
    assert read("device_idle_pct.run")(_reading(peaks=None,
                                                trace=trace)) is None
    serve = _reading(kind="serve", engine={
        "member_steps": 800, "launch_wall_s": 2.5,
        "occupancy": {"1": 60, "2": 20}}, trace=trace)
    assert read("engine_occupancy.serve")(serve) == pytest.approx(100 / 80)
    assert read("engine_launch_share_pct.serve")(serve) == 25.0
    assert read("spd_multistep_roofline.serve")(serve) == pytest.approx(
        100 * 100 * 1.342177e9 / 3.35e12 / 4.2)
    assert read("spd_multistep_roofline.run")(serve) is None


def test_open_loop_is_fixed_by_the_seed():
    mix = harness.read_json(harness.BENCH / "traffic"
                            / "cavity-300x720.json")
    a, b = loads.open_loop(mix, 2**31 + 7, 10), loads.open_loop(
        mix, 2**31 + 7, 10)
    c = loads.open_loop(mix, 11, 10)
    for key in ("tenant", "steps", "pool"):
        assert np.array_equal(a[key], b[key])
    assert a["due_s"] == b["due_s"]
    assert sorted(a["steps"]) == sorted(c["steps"])
    assert sorted(a["tenant"]) == sorted(c["tenant"])
    assert sum(a["due_s"][:1]) > 0 and np.all(np.diff(a["due_s"]) > 0)
    assert a["due_s"][-1] == pytest.approx(c["due_s"][-1])
    assert not np.array_equal(a["steps"], c["steps"])
    assert a["in_window"] == int(np.sum(np.asarray(a["due_s"]) < 10))
    steps = np.asarray(a["steps"])
    assert steps.min() >= 64 and steps.max() <= 1024
    assert np.all(steps % 8 == 0)


def test_stratified_blocks_hold_every_stratum():
    rng = np.random.default_rng(3)
    out = loads.stratified(np.arange(64.0), 8, rng)
    assert sorted(out) == list(range(64))
    for block in out.reshape(-1, 8):
        assert sorted(int(v) // 8 for v in block) == list(range(8))


def test_step_law_is_log_uniform():
    steps = loads.step_counts({"law": "log_uniform", "min": 64,
                               "max": 1024, "multiple": 8}, 4000)
    mean = (1024 - 64) / math.log(16)
    assert np.mean(steps) == pytest.approx(mean, rel=0.02)


def test_trace_reduction():
    ms = 10**6
    events = [
        ("bench.window", False, 0, 100 * ms),
        ("run_for_point", True, 0, 100 * ms),       # device-side annotation
        ("void spd_multistep_kernel<false>(float const*)", True, 10 * ms,
         20 * ms),
        ("void spd_multistep_kernel<false>(float const*)", True, 15 * ms,
         30 * ms),
        ("Memcpy DtoH", True, 50 * ms, 60 * ms),
        ("engine.step", False, 0, 70 * ms),
        ("wait_arrival", False, 70 * ms, 100 * ms),
        ("aten::copy_", False, 35 * ms, 45 * ms),
        ("before the window", True, -50 * ms, -10 * ms),
    ]
    red = tracing.reduce_events(events)
    assert red["window_s"] == pytest.approx(0.1)
    assert red["busy_s"] == pytest.approx(0.03)
    n, sec = red["kernels"]["spd_multistep_kernel<false>"]
    assert n == 2 and sec == pytest.approx(0.025)
    gaps = dict(red["idle_gaps"])
    assert gaps == pytest.approx({"engine.step": 0.01,
                                  "engine.step/aten::copy_": 0.02,
                                  "wait_arrival": 0.04})
    bd = tracing.breakdown(red)
    assert bd["device_ops"][0][0] == "spd_multistep_kernel<false>"
    assert bd["idle_gaps"][0] == ["wait_arrival", pytest.approx(0.04)]
    assert tracing.reduce_events(events[1:]) is None


def test_nearest_rank():
    vals = list(range(1, 101))
    assert harness.nearest_rank(vals, 50) == 50
    assert harness.nearest_rank(vals, 95) == 95
    assert harness.nearest_rank([7.0], 95) == 7.0
