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
    """The default device is the card: without one the command exits
    non-zero with the port's message; ``--program`` is not ported yet."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit) as exc:
        cli.main(["explore", "--no-execute"])
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(["explore", "--device", "cpu", "--program"])
    assert exc.value.code == 2
    assert "--program" in capsys.readouterr().err


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
