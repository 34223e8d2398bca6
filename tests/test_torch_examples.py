"""The port's three examples (``examples/torch_*.py``) on the CPU at small
sizes, through their ``main(argv)`` with ``--device cpu``: the quickstart
prints exactly what the JAX quickstart prints; the LBM example restarted
from its checkpoint ends bitwise equal to the unbroken run, and its
checkpoint is the JAX package's format; the DSE walkthrough finds the
paper's (n, m) = (1, 4) and executes its frontier.
"""

import importlib.util
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_jax_examples_values(capsys):
    """Bitwise the same streams, hardware report, transforms and FPGA
    points: every printed line equal."""
    got = _example("torch_quickstart").main(["--device", "cpu"])
    port = capsys.readouterr().out
    _example("quickstart").main()
    jax_out = capsys.readouterr().out
    assert port == jax_out
    np.testing.assert_array_equal(got["bout1"], np.arange(5, 21, 2))
    assert got["cascade_equal"]


def _lbm(tmp, steps, capsys):
    out = _example("torch_lbm_simulation").main([
        "--device", "cpu", "--height", "32", "--width", "32", "--steps",
        str(steps), "--ckpt-every", "8", "--ckpt-dir", str(tmp)])
    return out, capsys.readouterr().out


def test_lbm_restart_is_bitwise_the_unbroken_run(tmp_path, capsys):
    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as ckpt

    whole, text = _lbm(tmp_path / "a", 16, capsys)
    assert whole["start"] == 0 and whole["done"] == 16
    assert len(whole["save_s"]) == 2 and whole["restore_s"] is None
    assert "MLUPS (cpu)" in text and "H100-target" in text
    first, _ = _lbm(tmp_path / "b", 8, capsys)
    assert first["done"] == 8
    resumed, text = _lbm(tmp_path / "b", 16, capsys)
    assert "restored checkpoint at step 8" in text
    assert resumed["start"] == 8 and resumed["restore_s"] is not None
    assert torch.equal(resumed["f"], whole["f"])
    assert not torch.equal(first["f"], whole["f"])
    assert ckpt.available_steps(str(tmp_path / "b")) == [8, 16]
    # the same command again restores step 16 and says it has nothing to run
    again, text = _lbm(tmp_path / "b", 16, capsys)
    assert again["start"] == again["done"] == 16 and again["mlups"] is None
    assert "nothing to run" in text and "MLUPS (cpu)" not in text
    assert torch.equal(again["f"], whole["f"])
    # the written checkpoint is the JAX package's format, bit for bit
    step, tree, _ = jckpt.restore_latest(
        str(tmp_path / "a"), {"f": np.zeros((9, 32, 32), np.float32)})
    assert step == 16
    np.testing.assert_array_equal(np.asarray(tree["f"]),
                                  whole["f"].numpy())


def test_dse_explore_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_MEASURE_CACHE", str(tmp_path / "mc.json"))
    report = _example("torch_dse_explore").main([
        "--device", "cpu", "--topk", "1", "--devices", "1", "--reps", "1",
        "--no-calibrate"])
    out = capsys.readouterr().out
    assert "-> best configuration: (n, m) = (1, 4)" in out
    assert report["fpga"]["best"]["n"] == 1 and report["fpga"]["best"]["m"] == 4
    for app in ("lbm", "diffusion"):
        assert report[app]["executed"]
        assert all(e["interpret"] for e in report[app]["executed"])


def test_serve_lm_is_the_greedy_forward(capsys):
    """``torch_serve_lm.py --device cpu``: the reference example's prompts
    (the same seeded numpy draws), and every completion the argmax of the
    model's forward over the prompt and the tokens before it."""
    out = _example("torch_serve_lm").main(["--device", "cpu", "--requests",
                                           "5", "--max-batch", "2",
                                           "--new-tokens", "6"])
    text = capsys.readouterr().out
    assert "[serve] 5 requests, 30 tokens" in text
    rng = np.random.default_rng(0)
    bundle, model = out["bundle"], out["model"]
    for rid in range(5):
        prompt = rng.integers(1, 4096, size=rng.integers(4, 12)).tolist()
        assert out["prompts"][rid] == prompt
        seq = list(prompt)
        for tok in out["completions"][rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor([seq])})
            assert tok == int(logits[0, -1].argmax())
            seq.append(tok)
