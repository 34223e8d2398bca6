"""The Kimi Linear train cell's pieces on the CPU: its configuration
through the adapter against the reference's leaves on ``meta``, and the
reader of ``kda_share_pct.train``."""

import json
import math

import pytest

from bench import harness, roofline
from bench.apps import lm_train
from bench.reference import kimi_linear

CELL = "kimi-linear-27l-2x8192.train"
SPEC = harness.find_cell(CELL)


def test_the_configuration_loads_and_its_leaves_are_the_references():
    """``arch_config`` takes the file (the reference's ``ARCH`` and
    ``MOE`` hold: NoPE, no query latent, ε 1e-5, gates × 2.446), and the
    port's leaves built on ``meta`` are the reference's, names, shapes and
    dtypes, at the file's sizes; their count is the frozen one."""
    from repro_torch.interop import param_tree
    from repro_torch.models import registry

    config = SPEC.config
    cfg = lm_train.arch_config(config)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.moe.held) == (
        27, 2304, 20480, 8)
    assert (cfg.head_dim, cfg.q_rank, cfg.use_rope, cfg.norm_eps) == (
        192, 0, False, 1e-5)
    assert sum(cfg.is_kda(i) for i in range(cfg.n_layers)) == 20
    model = registry.build(cfg, device="meta").init()
    leaves = lm_train.named_leaves(param_tree(model))
    specs = kimi_linear.leaf_specs(config)
    assert {n: (tuple(x.shape), x.dtype) for n, x in leaves.items()} == {
        s[0]: (tuple(s[1]), s[2]) for s in specs}
    assert sum(math.prod(s[1]) for s in specs) == \
        config["frozen"]["params"] == 2_823_857_024


def test_the_frozen_flops_follow_the_widths():
    """``model_flops_per_step``: 6 × the active parameters × the tokens, 3
    × the 7 MLA layers' causal flash flops and 3 × the 20 KDA layers'
    chunked-form products at chunk 64."""
    f, mix = SPEC.config["frozen"], SPEC.mix
    b, t, c, h, d = mix["batch"], mix["seq"], 64, 32, 128
    flash = 2 * (192 + 128) * h * b * t * (t + 1) // 2
    bwd = 2 * (3 * 192 + 2 * 128) * h * b * t * (t + 1) // 2
    kda = 2 * (3 * c * c * d + 2 * c * c * d + 3 * c * d * d) * h * b * t // c
    assert f["flash_flops_per_launch"] == flash
    assert f["flash_bwd_flops_per_call"] == bwd
    assert f["tokens_per_step"] == b * t
    assert f["model_flops_per_step"] == (6 * f["active_params"] * b * t
                                         + 3 * 7 * flash + 3 * 20 * kda)


def test_kda_share_reads_the_time_under_its_function():
    """``kda_share_pct.train``: card-seconds under ``trace_ops["kda"]`` over
    the cards × the window; nothing without the entry, or without a
    trace, or off a train cell."""
    read = harness.load_reader("kda_share_pct.train")
    peaks = roofline.PEAKS["H100"]
    trace = {"window_s": 10.0, "busy_s": 9.5, "kernels": {},
             "device_s_under": {"kda": 6.1, "attention_backward": 0.2}}
    r = harness.Reading(kind="train", frozen=SPEC.config["frozen"],
                        peaks=peaks, cells=0, window_s=10.0, trace=trace)
    assert read(r) == pytest.approx(61.0)
    other = json.loads(json.dumps(SPEC.config["frozen"]))
    del other["trace_ops"]["kda"]
    r.frozen = other
    assert read(r) is None
    r.frozen, r.trace = SPEC.config["frozen"], None
    assert read(r) is None
    r.trace, r.kind = trace, "run"
    assert read(r) is None
