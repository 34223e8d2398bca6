"""``python -m repro_torch.cli explore`` against the JAX package's
``explore_main``.

Without execution the two print the same section 1 (the paper's FPGA
lattice: best (n, m) = (1, 4)) and the same section 4 (the LM fleet plan
table), and their ``--json`` reports hold the same ``fpga`` section,
exactly. The executing runs take the CPU (``--device cpu``: the
kernels' plain versions) and assert counts, never host-timed rates.
"""

import json

import pytest
import torch

from repro.cli import explore_main as jexplore
from repro_torch import cli


def _sections(text: str) -> dict:
    """{section number: its text}, split at the ``N) `` headers."""
    out, cur = {}, None
    for line in text.splitlines():
        head = line.split(")", 1)[0]
        if head and head[0].isdigit() and ") " in line[:5]:
            cur = head
            out[cur] = []
        elif cur is not None:
            out[cur].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def test_no_execute_matches_the_reference(tmp_path, capsys):
    pjson, jjson = tmp_path / "port.json", tmp_path / "jax.json"
    report = cli.main(["explore", "--device", "cpu", "--no-execute",
                       "--json", str(pjson)])
    port_out = capsys.readouterr().out
    jexplore(["--no-execute", "--json", str(jjson)])
    jax_out = capsys.readouterr().out
    assert "-> best configuration: (n, m) = (1, 4)" in port_out
    got, want = json.loads(pjson.read_text()), json.loads(jjson.read_text())
    assert got["fpga"] == want["fpga"] == report["fpga"]
    assert got["fpga"]["best"]["n"] == 1 and got["fpga"]["best"]["m"] == 4
    ps, js = _sections(port_out), _sections(jax_out)
    assert ps["1"] == js["1"]
    assert ps["4"].split("\n[wrote")[0] == js["4"].split("\n[wrote")[0]
    assert "NVIDIA H100 SXM" in port_out and "v5e" not in port_out
    assert set(got) - {"gpu", "device"} == set(want) - {"tpu"}
    assert got["gpu"]["best"]["feasible"]


def test_without_a_card_cuda_is_refused(capsys):
    """The default device is the card: without one ``explore`` (with or
    without ``--program``) and ``serve`` exit non-zero with the port's
    message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for argv in (["explore", "--no-execute"],
                 ["explore", "--no-execute", "--program"], ["serve"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err


def test_program_search_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--program`` (section 3c) searches both stream programs: the
    report holds each under ``"program"``, every executed point runs a
    partition of its program, and no search spends more than its
    budget."""
    from repro_torch.core.program import fusion_partitions

    monkeypatch.setenv("REPRO_TORCH_MEASURE_CACHE", str(tmp_path / "mc.json"))
    report = cli.main(["explore", "--device", "cpu", "--devices", "1",
                       "--strategy", "halving", "--budget", "4",
                       "--no-calibrate", "--reps", "1", "--program"])
    out = capsys.readouterr().out
    assert "3c) Stream programs" in out and "-> best partition:" in out
    stages = {"lbm_program": 3, "advection_diffusion": 2}
    assert set(report["program"]) == set(stages)
    for label, n in stages.items():
        res = report["program"][label]
        assert res["executed"] and 0 < res["budget_spent"] <= 4
        for e in res["executed"]:
            assert e["fusion"] in fusion_partitions(n)
            assert e["interpret"] and e["d"] == 1


def test_budgeted_search_and_its_cached_repeat(tmp_path, monkeypatch,
                                               capsys):
    """The halving search of both apps on the CPU spends at most its
    budget and runs only feasible points; the same command again is
    served by the measurement cache and spends nothing."""
    monkeypatch.setenv("REPRO_TORCH_MEASURE_CACHE", str(tmp_path / "mc.json"))
    argv = ["explore", "--device", "cpu", "--devices", "1", "--topk", "1",
            "--strategy", "halving", "--budget", "12", "--no-calibrate",
            "--reps", "1", "--json", str(tmp_path / "r.json")]
    first = cli.main(argv)
    second = cli.main(argv)
    out = capsys.readouterr().out
    assert "plan(s) declined" in out
    for app in ("lbm", "diffusion"):
        assert 0 < first[app]["budget_spent"] <= 12
        assert second[app]["budget_spent"] == 0
        assert all(e["cached"] for e in second[app]["executed"])
        for e in first[app]["executed"]:
            assert e["interpret"] and e["d"] == 1
            assert e["calibrated_gflops"] is None
    assert first["measure"]["cache"]["misses"] > 0
    assert second["measure"]["cache"]["hits"] > 0


def test_usage_without_a_subcommand(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([])
    assert exc.value.code == 2
    assert "explore" in capsys.readouterr().err


def test_serve_on_the_cpu_writes_its_json(tmp_path, capsys):
    """``serve --device cpu``: the reference's tenant mix, every request
    retired, the reference's stats keys (plus the tick's split, the served
    wall, the end-to-end and launch-wall MLUPS and ``device``) in the
    JSON, the tick split in the summary; a
    second run on the same study directory takes 0 live timings and pins
    the same plans."""
    def serve(name):
        path = tmp_path / name
        stats = cli.main(["serve", "--device", "cpu", "--requests", "2",
                          "--steps", "8", "--study-dir",
                          str(tmp_path / "studies"), "--json", str(path)])
        return stats, json.loads(path.read_text()), capsys.readouterr().out

    stats, got, out = serve("cold.json")
    assert set(got) == {
        "ticks", "submitted", "rejected", "completed", "launches",
        "member_steps", "launch_wall_s", "enqueue_s", "dissolve_s",
        "tick_s", "waits", "wait_s", "steps_per_s", "occupancy",
        "tuning_ticks", "live_timings", "plans", "latency", "served_s",
        "mlups", "launch_mlups", "device"}
    assert got["completed"] == got["submitted"] == 6
    assert got["rejected"] == 0 and got["device"] == "cpu"
    assert set(got["latency"]) == {"p50_s", "p95_s", "p99_s"}
    assert 0 < got["live_timings"] <= 12 and len(got["plans"]) == 3
    assert got["member_steps"] == 6 * 8 and stats["plans"] == got["plans"]
    # the end-to-end span holds every launch
    assert got["served_s"] >= got["launch_wall_s"] > 0
    assert "diffusion-32x32-a0.2, diffusion-64x64-a0.1, lbm-tgv-32x32" in out
    assert "batch occupancy: b=" in out and "MLUPS end to end" in out
    assert "tick split: enqueue " in out and "of the served wall" in out
    assert "waits on the card: 0 " in out  # the CPU has none
    _, warm, out = serve("warm.json")
    assert warm["live_timings"] == 0 and "warm start" in out
    for key, plan in got["plans"].items():
        assert {k: v for k, v in warm["plans"][key].items()
                if k not in ("budget_spent", "replayed")} == \
            {k: v for k, v in plan.items()
             if k not in ("budget_spent", "replayed")}
