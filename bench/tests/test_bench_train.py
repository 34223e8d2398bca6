"""The ``train`` kind: the Mixtral reference, the harness's training run,
its faults and control, its arithmetic and the trace's attribution.

The CPU tests take a Mixtral-shaped toy (2 layers, d_model 64, 4 heads
over 2 KV heads of 16, 4 experts top-2 of width 32, vocabulary 256,
2×32 tokens a step) through ``run_cell``'s ``config=``/``overrides=``;
the toy runs in float32 unless a test says otherwise, so the port and
the reference compute alike. The ``cuda`` test runs the cell's own size
on the card (``python -m pytest -m cuda bench/tests/test_bench_train.py``)
and skips without one.
"""

import math

import numpy as np
import pytest
import torch

from bench import harness, loads, roofline, tracing
from bench.apps import lm_train
from bench.reference import mixtral

CELL = "mixtral-2l-2x2048.train"
SEED = 2**31 + 23
MIX = {"batch": 2, "seq": 32}
SPEC = harness.find_cell(CELL)


def toy(dtype="float32", **kw):
    return {**SPEC.config, "n_layers": 2, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 2, "head_dim": 16, "vocab": 256, "dtype": dtype,
            "moe": {**SPEC.config["moe"], "n_experts": 4, "d_ff": 32},
            **kw}


def run(seconds=0.3, **kw):
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            overrides=MIX, config=toy(), log=lambda m: None,
                            **kw)


def test_reference_matches_the_port_in_f32():
    """Loss and every leaf's gradient of the port's plain path (the
    chunked attention on the CPU) against the reference, in float32, on
    the benchmark's weights: within 2e-5 of the reference's norm (the
    sum orders differ; a dropped expert or a wrong rope is O(1))."""
    from repro_torch.interop import leaf_parts, param_tree
    from repro_torch.models import registry

    config, mix = toy(), {**SPEC.mix, **MIX}
    system = lm_train.build(config, mix, "cpu", SEED)
    bundle = registry.build(system.cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in system.batch(0).items()}
    leaves = lm_train.named_leaves(param_tree(system.model))
    parts = {n: leaf_parts(x) for n, x in leaves.items()}
    flat = [x.requires_grad_() for ps in parts.values() for x in ps]
    loss = bundle.loss(system.model, batch)
    grads = iter(torch.autograd.grad(loss, flat))
    ours = {n: torch.stack([next(grads) for _ in ps]) if len(ps) > 1
            else next(grads) for n, ps in parts.items()}

    specs = mixtral.leaf_specs(config)
    p = {s[0]: mixtral.draw(s, SEED, i, "cpu").requires_grad_()
         for i, s in enumerate(specs)}
    ref_loss, dropped = mixtral.loss(p, batch, config)
    ref = dict(zip(p, torch.autograd.grad(ref_loss, list(p.values()))))
    assert int(dropped) > 0  # the toy's capacity binds: drops are checked
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                  rel=1e-6)
    assert set(ours) == set(ref)
    for name, g in ref.items():
        gap = float((ours[name].float() - g).norm() / g.norm())
        assert gap < 2e-5, (name, gap)


def test_leaf_specs_are_the_ports_leaves():
    system = lm_train.build(toy("bfloat16"), {**SPEC.mix, **MIX}, "cpu",
                            SEED)
    assert [s[0] for s in system.specs] == list(system.leaves)
    assert system.leaves["moe_layers.moe.router"].dtype == torch.float32
    assert system.leaves["embed"].dtype == torch.bfloat16


def test_a_port_that_departs_from_the_reference_is_refused():
    with pytest.raises(ValueError, match="does not"):
        lm_train.arch_config({**toy(), "arch": "qwen3-8b"})


def test_the_train_cell_runs_and_is_correct():
    out = run()
    res = out["result"]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"loss_rel_gap", "grad_norm_gap",
                                  "update_norm_gap"}
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    m = res["metrics"]
    assert set(m) == {"tokens_per_s", "setup_s"}
    assert m["tokens_per_s"]["unit"] == "tokens/s"
    info = out["info"]
    assert res["attempted"] == info["steps"] > 0 and res["failed"] == 0
    assert info["tokens"] == info["steps"] * 64
    assert m["tokens_per_s"]["value"] == pytest.approx(
        info["tokens"] / info["window_s"])
    assert info["checked"]["steps"] == 3


@pytest.mark.parametrize("fault", lm_train.FAULTS)
def test_a_broken_step_is_not_correct(fault):
    with lm_train.plant(fault):
        res = run()["result"]
    assert not res["correct"], res["checks"]


def test_the_control_fails():
    out = run(control=True)
    checks = out["result"]["checks"]
    assert out["result"]["correct"]
    assert any(out["info"][f"control_fp8_{k}"] > c["limit"]
               for k, c in checks.items())


def test_faults_restore_the_port():
    from repro_torch.models import layers, transformer
    from repro_torch.train import optimizer

    before = (layers.moe_router, transformer.lm_loss,
              optimizer.apply_updates)
    for fault in lm_train.FAULTS:
        with lm_train.plant(fault):
            pass
    assert (layers.moe_router, transformer.lm_loss,
            optimizer.apply_updates) == before


def test_train_gaps_by_the_worst_leaf():
    ref = {"loss": [10.0, 10.0], "grad_norm": {"a": 1.0, "b": 4.0,
                                               "c": 1e-9},
           "change_norm": {"a": 2.0, "b": 0.0, "c": 5.0}}
    prog = {"loss": [10.0, 10.05], "grad_norm": {"a": 1.5, "b": 4.0,
                                                 "c": 1.0},
            "change_norm": {"a": 2.0, "b": 0.2, "c": 50.0}}
    gaps = harness.train_gaps(prog, ref)
    assert gaps["loss_rel_gap"] == pytest.approx(0.005)
    # c's gradient is nought to rounding: left out of both numbers
    assert gaps["grad_norm_gap"] == pytest.approx(0.5 / 2.5)
    assert gaps["update_norm_gap"] == pytest.approx(0.2 / 1.0)
    prog["loss"][0] = math.nan
    assert harness.train_gaps(prog, ref)["loss_rel_gap"] == math.inf


def test_tokens_and_mfu_arithmetic():
    frozen = SPEC.config["frozen"]
    peaks = roofline.PEAKS["H100"]
    r = harness.Reading(kind="train", frozen=frozen, peaks=peaks, cells=0,
                        window_s=10.0, steps=27, tokens=27 * 4096)
    mfu = harness.load_reader("mfu_pct.train")(r)
    assert mfu == pytest.approx(100 * 27 * 23014246711296 / 10 / 989e12)
    assert harness.load_reader("mfu_pct.run")(r) is None
    trace = {"window_s": 10.0, "busy_s": 9.0,
             "kernels": {"flash_kernel<128, 64>": (108, 0.02),
                         "ampere_bf16_gemm": (500, 5.0)},
             "device_s_under": {"attention_backward": 1.3}}
    r.trace = trace
    read = harness.load_reader
    assert read("flash_attention_roofline.train")(r) == pytest.approx(
        100 * 108 * 68753031168 / 989e12 / 0.02)
    assert read("attention_backward_share_pct.train")(r) == \
        pytest.approx(13.0)
    assert read("device_idle_pct.train")(r) == pytest.approx(10.0)
    assert read("device_idle_pct.run")(r) is None
    run_reading = harness.Reading(kind="run", frozen=frozen, peaks=peaks,
                                  cells=16, window_s=1.0, trace=trace)
    for name in ("mfu_pct.train", "flash_attention_roofline.train",
                 "attention_backward_share_pct.train",
                 "device_idle_pct.train"):
        assert read(name)(run_reading) is None


def test_frozen_flops_follow_the_widths():
    c = SPEC.config
    d, hd, e = c["d_model"], c["head_dim"], c["moe"]
    attn = d * hd * (2 * c["n_heads"] + 2 * c["n_kv_heads"])
    active = c["n_layers"] * (attn + d * e["n_experts"]
                              + e["top_k"] * 3 * d * e["d_ff"]) \
        + d * c["vocab"]
    mix = SPEC.mix
    tokens = mix["batch"] * mix["seq"]
    flash = 4 * hd * c["n_heads"] * mix["batch"] * mix["seq"] * (
        mix["seq"] + 1) // 2
    f = c["frozen"]
    assert f["active_params"] == active == 919666688
    assert f["tokens_per_step"] == tokens
    assert f["flash_flops_per_launch"] == flash
    assert f["model_flops_per_step"] == 6 * active * tokens \
        + 3 * c["n_layers"] * flash
    total = sum(math.prod(s[1]) for s in mixtral.leaf_specs(c))
    assert total == 3164688384


def test_token_batches_are_fixed_by_the_seed():
    mix = SPEC.mix
    a = loads.token_batch(mix, 32000, SEED, 5)
    b = loads.token_batch(mix, 32000, SEED, 5)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 2048) and a["tokens"].dtype == np.int32
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"][0], a["tokens"][1])
    assert not np.array_equal(
        a["tokens"], loads.token_batch(mix, 32000, SEED, 6)["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 32000


def _stencil_events():
    ms = 10**6
    return [
        ("bench.window", False, 0, 100 * ms),
        ("run_for_point", True, 0, 100 * ms),
        ("void spd_multistep_kernel<false>(float const*)", True, 10 * ms,
         20 * ms),
        ("void spd_multistep_kernel<false>(float const*)", True, 15 * ms,
         30 * ms),
        ("Memcpy DtoH", True, 50 * ms, 60 * ms),
        ("engine.step", False, 0, 70 * ms),
        ("wait_arrival", False, 70 * ms, 100 * ms),
        ("aten::copy_", False, 35 * ms, 45 * ms),
    ]


def test_trace_credits_device_time_to_the_launching_op():
    ms = 10**6
    bwd = "autograd::engine::evaluate_function: FlashAttentionFnBackward"
    events = [
        ("bench.window", False, 0, 100 * ms, 0, 0),
        ("train.step", False, 0, 100 * ms, 0, 0),
        ("train.step", True, 0, 100 * ms, 0, 0),
        (bwd, False, 10 * ms, 30 * ms, 0, 0),
        (bwd, False, 12 * ms, 14 * ms, 0, 0),  # nested: counts once
        ("cudaLaunchKernel", False, 11 * ms, 11 * ms + 5, 0, 7),
        ("cudaLaunchKernel", False, 13 * ms, 13 * ms + 5, 0, 8),
        ("cudaLaunchKernel", False, 40 * ms, 40 * ms + 5, 0, 9),
        ("aten::bmm", False, 39 * ms, 41 * ms, 0, 9),
        # launched under the backward, run after it: still its time
        ("void gemm_a(float)", True, 25 * ms, 35 * ms, 0, 7),
        ("void gemm_b(float)", True, 35 * ms, 37 * ms, 0, 8),
        ("void gemm_c(float)", True, 45 * ms, 60 * ms, 0, 9),
        ("void gemm_d(float)", True, 95 * ms, 110 * ms, 0, 0),
        # an annotation's device-side copy, with a launch's correlation id
        (bwd, True, 25 * ms, 37 * ms, 0, 7),
    ]
    red = tracing.reduce_events(events, ops={"attention_backward":
                                             "FlashAttentionFnBackward"})
    assert red["device_s_under"] == pytest.approx(
        {"attention_backward": 0.012})
    assert red["busy_s"] == pytest.approx(0.012 + 0.015 + 0.005)
    assert red["kernels"]["gemm_a"] == (1, pytest.approx(0.01))
    plain = tracing.reduce_events([e[:5] for e in events])
    assert "device_s_under" not in plain
    assert {**plain, "device_s_under": red["device_s_under"]} == red


def test_trace_of_a_stencil_run_reads_as_before():
    """A recorded stencil trace: every key the reduction returned before
    the attribution keeps its value, with or without correlation ids."""
    events = _stencil_events()
    red = tracing.reduce_events(events)
    with_ids = tracing.reduce_events([e + (0, 0) for e in events])
    assert red["window_s"] == pytest.approx(0.1)
    assert red["busy_s"] == pytest.approx(0.03)
    assert red["kernels"]["spd_multistep_kernel<false>"] == (
        2, pytest.approx(0.025))
    assert dict(red["idle_gaps"]) == pytest.approx(
        {"engine.step": 0.01, "engine.step/aten::copy_": 0.02,
         "wait_arrival": 0.04})
    assert "device_s_under" not in red
    assert with_ids == red
    assert tracing.reduce_events(events, ops={})["device_s_under"] == {}
    assert set(tracing.breakdown(red)) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
def test_controls_and_faults_fail_at_the_cells_size(card):
    """At the cell's own size on the card: sound runs are correct, and the
    fp8 control and each planted fault come out not correct."""
    seeds = (2**31 + 501, 2**31 + 502, 2**31 + 503)
    for seed in seeds:
        out = harness.run_cell(CELL, seed, 1.0, False, control=True,
                               log=lambda m: None)
        checks = out["result"]["checks"]
        assert out["result"]["correct"], checks
        assert any(out["info"][f"control_fp8_{k}"] > c["limit"]
                   for k, c in checks.items()), (seed, out["info"])
    for fault in lm_train.FAULTS:
        with lm_train.plant(fault):
            res = harness.run_cell(CELL, seeds[0], 1.0, False,
                                   log=lambda m: None)["result"]
        assert not res["correct"], (fault, res["checks"])
