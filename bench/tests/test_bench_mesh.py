"""A run on several cards: the devices the result line reports, the card
count ``bench/run.py`` holds a cell to, the trace reduced per card, the
mesh cell's readers, and the mesh cell itself on the CPU (its shards on
``["cpu"] * 4``) and, marked ``cuda``, on four distinct cards."""

import json
import sys

import pytest
import torch

from bench import harness, roofline, tracing

MESH = "lbm-tgv-8192.mesh4"
SEED = 2**31 + 23
H100 = "NVIDIA H100 80GB HBM3"


# --------------------------------------------------------------------------
# the result line's device
# --------------------------------------------------------------------------


def test_one_device_counts_once():
    assert harness._device_info([torch.device("cpu")])["count"] == 1
    info = harness._device_info(["cpu"] * 4)
    assert info == {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}


def _fake_cards(monkeypatch, names, peaks):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(peaks))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: names[torch.device(dev).index])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev: peaks[torch.device(dev).index])


CARDS = [f"cuda:{i}" for i in range(4)]


def test_four_cards_count_four_with_the_fullest_peak(monkeypatch):
    peaks = [7 * 2**30, 2**30, 3 * 2**30, 2**30]
    _fake_cards(monkeypatch, [H100] * 4, peaks)
    info = harness._device_info(CARDS)
    assert info == {"platform": "gpu", "kind": H100, "count": 4,
                    "memory_peak_bytes": 7 * 2**30,
                    "memory_peak_bytes_per_device": peaks}


def test_cards_the_run_left_empty_do_not_count(monkeypatch):
    """Given four cards, a run that held every shard on the first counts
    one: the count is read from the cards' memory, not from the list."""
    _fake_cards(monkeypatch, [H100] * 4, [7 * 2**30, 0, 0, 0])
    info = harness._device_info(CARDS)
    assert info["count"] == 1
    assert info["memory_peak_bytes_per_device"] == [7 * 2**30]
    _fake_cards(monkeypatch, [H100] * 4, [0, 0, 2**30, 0])
    assert harness._device_info(["cuda:0"])["count"] == 1
    _fake_cards(monkeypatch, [H100] * 4, [0] * 4)
    with pytest.raises(RuntimeError, match="no memory"):
        harness._device_info(CARDS)


def test_cards_of_different_kinds_fail(monkeypatch):
    _fake_cards(monkeypatch, [H100, "NVIDIA A100-SXM4-80GB"], [1, 1])
    with pytest.raises(RuntimeError, match="differ in kind"):
        harness._device_info(["cuda:0", "cuda:1"])
    _fake_cards(monkeypatch, [H100, "NVIDIA A100-SXM4-80GB"], [1, 0])
    assert harness._device_info(["cuda:0", "cuda:1"])["kind"] == H100


def test_mesh_kernel_puts_one_shard_on_each_card():
    cfg = harness.find_cell(MESH).config
    app = __import__(f"bench.apps.{cfg['app']}", fromlist=["build"])
    system = app.build(cfg, (64, 64), "cpu")
    point = harness._model_plan(system, cfg)
    assert point.detail["d"] == 4
    assert harness.mesh_devices(torch.device("cuda"), 4) == [
        torch.device("cuda", i) for i in range(4)]
    kern, on_cpu = harness.mesh_kernel(system.kernel, 4, 1,
                                       torch.device("cpu"))
    assert (kern.d, kern.dy, kern.dx) == (4, 4, 1)
    assert harness.distinct_devices(on_cpu) == [torch.device("cpu")]


def _run_main(monkeypatch, peaks):
    """``bench/run.py`` on the mesh cell, over a run whose result line's
    ``device`` is read from four mocked cards with these peaks."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    from bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(run, "card_line", lambda: H100)
    _fake_cards(monkeypatch, [H100] * 4, peaks)

    def run_cell(*a, **k):
        line = {"correct": True, "attempted": 3, "failed": 0,
                "metrics": {}, "device": harness._device_info(CARDS),
                "checks": {"max_abs_gap": {"value": 0.0, "limit": 1e-4}}}
        return {"result": line, "info": {}}

    monkeypatch.setattr(harness, "run_cell", run_cell)
    return run.main(["--workload", MESH, "--seed", "1", "--seconds", "1",
                     "--trace", "0"])


@pytest.mark.parametrize("peaks", [[2**30, 0, 0, 0], [2**30, 2**30, 0, 2**30]])
def test_run_fails_where_the_run_used_fewer_cards(monkeypatch, capsys,
                                                  peaks):
    rc = _run_main(monkeypatch, peaks)
    out = capsys.readouterr()
    assert rc == 4 and '"correct"' not in out.out
    assert f"used {sum(p > 0 for p in peaks)}" in out.err


def test_run_on_four_cards_prints_its_line(monkeypatch, capsys):
    assert _run_main(monkeypatch, [2**30] * 4) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["device"]["count"] == 4


# --------------------------------------------------------------------------
# the trace, per card
# --------------------------------------------------------------------------

MS = 10**6
KERNEL = "void spd_multistep_kernel<true>(float const*)"


def test_an_idle_card_shows_as_idle():
    events = [
        ("bench.window", False, 0, 100 * MS),
        ("run_for_point", False, 0, 100 * MS),
        (KERNEL, True, 0, 80 * MS, 0),
        (KERNEL, True, 10 * MS, 50 * MS, 0),   # overlaps on card 0
        (KERNEL, True, 20 * MS, 60 * MS, 1),
        ("Memcpy PtoP (Device -> Device)", True, 90 * MS, 100 * MS, 1),
    ]
    red = tracing.reduce_events(events, devices=[0, 1, 2])
    assert red["busy_s_per_device"] == pytest.approx([0.08, 0.05, 0.0])
    assert red["busy_s"] == pytest.approx(0.13 / 3)
    n, sec = red["kernels"]["spd_multistep_kernel<true>"]
    assert n == 3 and sec == pytest.approx(0.08 + 0.04 + 0.04)
    assert red["kernels"]["Memcpy PtoP"] == (1, pytest.approx(0.01))
    gaps = dict(red["idle_gaps"])
    assert gaps == {"run_for_point": pytest.approx((0.02 + 0.05 + 0.1) / 3)}
    assert sum(gaps.values()) + red["busy_s"] == pytest.approx(0.1)
    seen = tracing.reduce_events(events)  # the cards with events
    assert seen["busy_s_per_device"] == pytest.approx([0.08, 0.05])


def _recorded_events():
    """A single-card event list with uneven nanosecond times, drawn from a
    fixed linear congruential sequence."""
    x = 20261018

    def draw(lo, hi):
        nonlocal x
        x = (6364136223846793005 * x + 1442695040888963407) % 2**64
        return lo + (x >> 33) % (hi - lo)

    kernels = ("void spd_multistep_kernel<false>(float const*, float*)",
               "Memcpy DtoH (Device -> Pageable)",
               "void at::native::vectorized_elementwise_kernel<4>(int)")
    spans = ("run_for_point", "engine.step", "submit", "wait_arrival",
             "check")
    ops = ("aten::copy_", "cudaLaunchKernel", "aten::empty", "spd.launch")
    events = [("bench.window", False, 1_000_003, 901_234_567),
              ("run_for_point", True, 0, 950_000_000)]
    t = 0
    for i in range(40):
        t += draw(1_000, 40_000_000)
        events.append((kernels[i % 3], True, t, t + draw(500, 30_000_000)))
    for i in range(25):
        s = draw(0, 950_000_000)
        events.append((spans[i % 5], False, s, s + draw(1_000, 60_000_000)))
    for i in range(60):
        s = draw(0, 950_000_000)
        events.append((ops[i % 4], False, s, s + draw(1_000, 9_000_000)))
    return events


#: What the one-card reduction of the benchmark's first version (before
#: the reduction per card) returned for :func:`_recorded_events`.
ONE_CARD = {
    "window_s": 0.900234564,
    "busy_s": 0.448870674,
    "kernels": {
        "spd_multistep_kernel<false>": (14, 0.20744446099999997),
        "Memcpy DtoH": (13, 0.21654075200000003),
        "at::native::vectorized_elementwise_kernel<4>": (
            13, 0.19022493799999998),
    },
    "idle_gaps": [
        ("no span", 0.12787656),
        ("check", 0.117264143),
        ("run_for_point", 0.097445284),
        ("engine.step", 0.038806113),
        ("submit", 0.028360208999999997),
        ("no span/aten::empty", 0.014653148),
        ("no span/aten::copy_", 0.007993397),
        ("wait_arrival/cudaLaunchKernel", 0.007021988),
        ("submit/aten::empty", 0.004759169),
        ("wait_arrival/aten::empty", 0.003910813),
        ("run_for_point/cudaLaunchKernel", 0.003273066),
    ],
}


@pytest.mark.parametrize("card", [None, 0, 3])
def test_one_card_reduces_as_before(card):
    events = _recorded_events()
    if card is not None:
        events = [ev + (card,) if ev[1] else ev for ev in events]
    red = tracing.reduce_events(
        events, devices=None if card is None else [card])
    assert red.pop("busy_s_per_device") == [ONE_CARD["busy_s"]]
    assert red == ONE_CARD


# --------------------------------------------------------------------------
# the mesh cell's readers
# --------------------------------------------------------------------------

FROZEN = {"flops_per_update": 131, "planes_read": 10, "planes_written": 10,
          "bytes_per_word": 4}


def _mesh_reading(**kw):
    trace = {"window_s": 10.0, "busy_s": 9.0,
             "busy_s_per_device": [9.6, 8.8, 8.8, 8.8],
             "kernels": {"spd_multistep_kernel<true>": (4 * 500, 36.0),
                         "Memcpy PtoP": (8000, 0.8),
                         "at::native::elementwise_kernel<128, 2, "
                         "at::native::direct_copy_kernel_cuda": (400, 0.4),
                         "Memcpy DtoH": (1, 0.2)}}
    base = dict(kind="run", frozen=FROZEN, peaks=roofline.PEAKS["H100"],
                cells=8192 * 8192, window_s=10.0, devices=4,
                updates=20 * 1024 * 8192 * 8192, launches=4 * 2560,
                plan={"block_h": 32, "m": 8, "block_w": 64, "d": 4,
                      "dy": 4, "dx": 1}, trace=trace)
    base.update(kw)
    return harness.Reading(**base)


def test_mesh_readers():
    """The run cells' readers on the mesh (each shard launch over the cells
    it owns, shares over the cards used) and the mesh's own two."""
    r = _mesh_reading()
    read = harness.load_reader
    assert read("mfu_pct.run")(r) == pytest.approx(
        100 * 131 * r.updates / 10 / (4 * 67e12))
    per = 20 * 4096 * 4096 * 4 / 3.35e12  # one shard launch's bytes
    assert read("spd_multistep_roofline.run")(r) == pytest.approx(
        100 * 2000 * per / 36.0)
    assert read("device_idle_pct.run")(r) == pytest.approx(10.0)
    assert read("steps_per_launch.run")(r) == pytest.approx(8.0)
    assert read("card_busy_spread_pct.mesh")(r) == pytest.approx(8.0)
    assert read("exchange_share_pct.mesh")(r) == pytest.approx(
        100 * 1.2 / 40.0)
    one_card = _mesh_reading(devices=1, plan={"m": 8, "d": 1})
    for name in ("mfu_pct.run", "spd_multistep_roofline.run",
                 "device_idle_pct.run", "card_busy_spread_pct.mesh",
                 "exchange_share_pct.mesh"):
        assert 0 < read(name)(r) < 100
        assert read(name)(_mesh_reading(kind="serve")) is None, name
    for name in ("card_busy_spread_pct.mesh", "exchange_share_pct.mesh"):
        assert read(name)(one_card) is None, name
        assert read(name)(_mesh_reading(peaks=None)) is None, name
    # On one card (devices 1, d 1) the run readers read as they always have.
    assert read("mfu_pct.run")(one_card) == pytest.approx(
        4 * read("mfu_pct.run")(r))
    assert read("steps_per_launch.run")(
        _mesh_reading(devices=1, plan={"m": 8}, launches=2560)) == 8.0
    no_copies = _mesh_reading()
    no_copies.trace["kernels"] = {"spd_multistep_kernel<true>": (8, 1.0)}
    assert read("exchange_share_pct.mesh")(no_copies) is None


# --------------------------------------------------------------------------
# the mesh cell, whole
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grid,mesh", [([64, 64], (4, 1)),
                                       ([16, 32], (1, 4))])
def test_mesh_cell_is_correct_on_the_cpu(grid, mesh):
    out = harness.run_cell(MESH, SEED, 0.5, False, device="cpu",
                           overrides={"grid": grid,
                                      "steps_per_simulation": 32},
                           log=lambda m: None)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 1
    plan = out["info"]["plan"]
    assert (plan["d"], plan["dy"], plan["dx"]) == (4,) + mesh
    assert set(res["metrics"]) == {"mlups", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("dx", [None, 2])
def test_mesh_on_four_cards_is_bitwise_one_card(card, dx):
    """The cell's path at 2048² on ``cuda:0 … cuda:3`` (the DSE's mesh, and
    a (2, 2) mesh) against the one-card launch at the same plan."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    cfg = harness.find_cell(MESH).config
    app = __import__(f"bench.apps.{cfg['app']}", fromlist=["build"])
    system = app.build(cfg, (2048, 2048), card)
    state = system.states(harness.find_cell(MESH).mix["init"], 1,
                          torch.Generator(card).manual_seed(SEED))[0]
    regs = system.regs({})
    point = harness._model_plan(system, cfg)
    kern, devices = harness.mesh_kernel(
        system.kernel, point.detail["d"], dx or point.detail["dx"], card)
    assert len(harness.distinct_devices(devices)) == 4
    out, (block_h, m, db) = kern.run_for_point(state, regs, point=point,
                                               steps=64)
    ref = system.kernel.run_blocked(state, regs, steps=64, m=m,
                                    block_h=block_h, double_buffer=db)
    harness._sync(devices)
    assert out.device == state.device
    assert torch.equal(out, ref)
