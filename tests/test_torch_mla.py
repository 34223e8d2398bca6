"""Kimi K2's mechanisms in the port, on the CPU at a small size: multi-head
latent attention, sigmoid routing with a selection bias, and the held
slice of the experts, against the benchmark's plain f32 reference
``bench/reference/kimi_k2.py`` on seeded weights (docs/port.md §mla)."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.apps.lm_train import arch_config, named_leaves
from bench.reference import kimi_k2 as ref
from repro_torch.configs import SHAPES, get_arch, shape_applicable
from repro_torch.interop import Stacked, leaf_parts, param_tree
from repro_torch.kernels.flash_attention.flash_attention import (
    HOPPER_DIMS,
    flash_attention,
    flash_attention_bwd_plain,
    takes_hopper_path,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked_ref,
    attention_lse_ref,
    attention_ref,
)
from repro_torch.models import layers, registry, transformer
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = Path(__file__).resolve().parents[1]
SEED = 2147483901

#: A small Kimi K2: every mechanism of the cell at widths the CPU runs in
#: a second. 3 layers (the dense one and 2 expert layers), 16 experts of
#: which 4 are held, top 4.
SMALL = {
    "n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "vocab": 128, "sliding_window": 0, "rope_theta": 50000.0,
    "dtype": "float32", "router_dtype": "float32", "norm_eps": 1e-6,
    "d_ff": 96, "q_rank": 32, "kv_rank": 16, "qk_nope_dim": 8,
    "qk_rope_dim": 8, "v_head_dim": 8,
    "moe": {"n_experts": 16, "top_k": 4, "d_ff": 32, "n_shared": 1,
            "moe_start_layer": 1, "capacity_factor": 1.0,
            "score_func": "sigmoid", "route_scale": 2.827, "n_held": 4,
            "held_start": 4},
    "optimizer": {"lr": 0.0003, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                  "weight_decay": 0.1, "clip_norm": 1.0,
                  "state_dtype": "float32", "warmup_steps": 100,
                  "total_steps": 10000, "min_lr_frac": 0.1},
}


def _port_cfg(small: dict):
    """The port's ``kimi-k2-instruct`` at ``small``'s sizes."""
    base = get_arch("kimi-k2-instruct")
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "vocab", "sliding_window", "rope_theta", "dtype", "d_ff",
            "q_rank", "kv_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim")
    return dataclasses.replace(
        base, **{k: small[k] for k in keys},
        moe=dataclasses.replace(base.moe, **small["moe"]))


def _port_model(small: dict, seed: int = SEED):
    """The port's model at ``small`` holding the reference's weights of
    ``seed``, and its bundle."""
    cfg = _port_cfg(small)
    bundle = registry.build(cfg, device="cpu")
    model = registry.build(cfg, device="meta").init()
    model.to_empty(device="cpu")
    leaves = named_leaves(param_tree(model))
    specs = ref.leaf_specs(small)
    assert {n: tuple(x.shape) for n, x in leaves.items()} == {
        s[0]: tuple(s[1]) for s in specs}
    with torch.no_grad():
        for i, spec in enumerate(specs):
            leaves[spec[0]].copy_(ref.draw(spec, seed, i, "cpu"))
    return bundle, model, leaves, specs


def _batch(small: dict, seed: int = SEED, batch: int = 2, seq: int = 24):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, small["vocab"], (batch, seq + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_the_reference_imports_no_jax_and_no_port_kernel():
    """``bench.reference.kimi_k2`` imports from the root under ``python
    -m pytest``, and brings in neither JAX nor anything of the port."""
    code = ("import sys; import bench.reference.kimi_k2; print(sorted(m for "
            "m in sys.modules if m.split('.')[0] in ('jax', 'repro', "
            "'repro_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


def test_port_equals_the_reference_loss_gradients_and_step():
    """The port's loss, every leaf's gradient, and one AdamW step against
    the reference's, both in f32 on the same weights and tokens. The
    capacity factor 1.0 drops assignments, the slice [4, 8) leaves most
    assignments to absent experts. Tolerances: the two compute the same
    f32 operations in another order (fused projections, another RMSNorm
    and softmax), so they differ by rounding, ~1e-6 relative, which the
    backward grows by at most ~10x; rtol 1e-4 on the gradients, 1e-5 on
    the loss, 1e-3 on each leaf's change, where Adam's first step moves
    an element by ~lr whatever its gradient's size. The selection bias
    keeps its drawn value in both: no gradient, and no weight decay."""
    bundle, model, leaves, specs = _port_model(SMALL)
    batch = _batch(SMALL)
    parts = [x for leaf in leaves.values() for x in leaf_parts(leaf)]
    for x in parts:
        x.requires_grad_(True)
    loss = bundle.loss(model, batch)
    grads = torch.autograd.grad(loss, parts, allow_unused=True)
    got, it = {}, iter(grads)
    for name, leaf in leaves.items():
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(leaf_parts(leaf), it)]
        got[name] = torch.stack(gs) if isinstance(leaf, Stacked) else gs[0]
    p = {s[0]: ref.draw(s, SEED, i, "cpu").requires_grad_()
         for i, s in enumerate(specs)}
    want_loss, dropped = ref.loss(p, batch, SMALL)
    assert int(dropped) > 0  # the capacity binds
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()),
                                           allow_unused=True)))
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for name in p:
        w = want[name]
        if w is None:
            assert name.endswith("select_bias")
            assert not got[name].any()
            continue
        torch.testing.assert_close(got[name], w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())
    for x in parts:
        x.requires_grad_(False)

    # one AdamW step through the port's train step
    opt_cfg = AdamWConfig(**SMALL["optimizer"])
    state = init_state(opt_cfg, param_tree(model))
    model, state, metrics = bundle.make_train_step(opt_cfg)(model, state,
                                                            batch)
    torch.testing.assert_close(metrics["loss"], want_loss.detach(),
                               rtol=1e-5, atol=0)
    out = ref.train(SMALL, SEED, [{k: v.numpy() for k, v in batch.items()}],
                    "cpu")
    leaves = named_leaves(param_tree(model))
    for i, spec in enumerate(specs):
        leaf = leaves[spec[0]]
        cur = leaf.stack() if isinstance(leaf, Stacked) else leaf.detach()
        change = (cur - ref.draw(spec, SEED, i, "cpu")).norm().item()
        assert math.isclose(change, out["change_norm"][spec[0]],
                            rel_tol=1e-3, abs_tol=1e-9), spec[0]
        if spec[0].endswith("select_bias"):  # nothing trains it
            assert change == 0 and out["change_norm"][spec[0]] == 0


def _moe_module(cfg, p, i, start, held):
    """The port's MoE of expert layer ``i`` of the reference's weights
    ``p``, holding experts ``[start, start + held)``."""
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_held=held, held_start=start))
    moe = layers.MoE(cfg, device="cpu")
    pre = "moe_layers.moe."
    with torch.no_grad():
        moe.router.copy_(p[pre + "router"][i])
        moe.select_bias.copy_(p[pre + "select_bias"][i])
        for w in ("w_gate", "w_up", "w_down"):
            getattr(moe, w).copy_(p[pre + w][i, start:start + held])
            getattr(moe.shared, w).copy_(p[pre + "shared." + w][i])
    return cfg, moe


def test_held_slices_and_the_shared_expert_sum_to_the_uncut_layer():
    """The share test: over slices that tile the 16 experts (4 cards of 4,
    and 2 of 8), each card's held part, with the shared expert counted
    once, adds up to the uncut layer of the reference (all 16 held), at a
    capacity that drops nothing (cf = E / k). f32; the parts sum in
    another order than the uncut layer's, so rtol 1e-5."""
    small = json.loads(json.dumps(SMALL))
    small["moe"].update(n_held=16, held_start=0, capacity_factor=4.0)
    cfg = _port_cfg(small)
    p = {s[0]: ref.draw(s, SEED, i, "cpu")
         for i, s in enumerate(ref.leaf_specs(small))}
    h = torch.randn((2, 24, small["d_model"]),
                    generator=torch.Generator().manual_seed(3))
    want, drops = ref.experts(p, 1, h, small, torch.matmul)
    assert int(drops) == 0
    _, whole = _moe_module(cfg, p, 1, 0, 16)
    torch.testing.assert_close(layers.moe_apply(whole, h, cfg), want,
                               rtol=1e-5, atol=1e-6)
    shared = layers.mlp_apply(whole.shared, h.reshape(-1, h.shape[-1]),
                              cfg).reshape(h.shape)
    for held in (4, 8):
        total = shared.clone()
        for start in range(0, 16, held):
            c, moe = _moe_module(cfg, p, 1, start, held)
            total += layers.moe_apply(moe, h, c) - shared
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def test_the_selection_bias_moves_the_choice_and_not_the_gates():
    """``moe_router`` under sigmoid routing: the gates are the chosen
    experts' sigmoid scores renormalised and times 2.827, whatever the
    bias; a bias that favours one expert puts it in every token's choice
    at the gate its score gives; and the bias gets no gradient."""
    cfg = _port_cfg(SMALL)
    moe = layers.MoE(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        moe.router.copy_(torch.randn(moe.router.shape, generator=g))
        moe.select_bias.zero_()
    xt = torch.randn((32, cfg.d_model), generator=g)
    scores = torch.sigmoid(xt @ moe.router)

    def law(idx):
        s = scores.gather(-1, idx)
        return s / s.sum(-1, keepdim=True) * 2.827

    gates, idx = layers.moe_router(moe, xt, cfg)
    assert torch.equal(idx, torch.topk(scores, 4, dim=-1).indices)
    torch.testing.assert_close(gates, law(idx))
    with torch.no_grad():
        moe.select_bias[11] = 10.0
    gates2, idx2 = layers.moe_router(moe, xt, cfg)
    assert (idx2 == 11).any(-1).all()
    assert not torch.equal(idx2, idx)
    torch.testing.assert_close(gates2, law(idx2))
    moe.select_bias.requires_grad_(True)
    moe.router.requires_grad_(True)
    gates3, _ = layers.moe_router(moe, xt, cfg)
    gb, gr = torch.autograd.grad(gates3.sum(), [moe.select_bias, moe.router],
                                 allow_unused=True)
    assert gb is None and gr is not None


@pytest.mark.parametrize("hq,hkv,causal", [(4, 4, True), (4, 2, True),
                                           (4, 1, False)])
def test_plain_flash_takes_a_narrower_v(hq, hkv, causal):
    """The plain flash path at D_qk 24 and D_v 16 (MLA's shape, narrowed):
    the forward (and the dispatcher's chunked path) against direct
    attention, and the plain backward against autograd through it; off
    the card neither is the Hopper path."""
    g = torch.Generator().manual_seed(6)
    b, s = 2, 48
    q = torch.randn((b, hq, s, 24), generator=g)
    k = torch.randn((b, hkv, s, 24), generator=g)
    v = torch.randn((b, hkv, s, 16), generator=g)
    do = torch.randn((b, hq, s, 16), generator=g)
    want = attention_ref(q, k, v, causal=causal)
    assert want.shape == (b, hq, s, 16)
    torch.testing.assert_close(flash_attention(q, k, v, causal=causal,
                                               block_q=16, block_k=16),
                               want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(attention_chunked_ref(q, k, v, causal=causal,
                                                     chunk=16),
                               want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(attention(q, k, v, causal=causal), want,
                               rtol=1e-5, atol=1e-5)
    assert not takes_hopper_path(q, v) and (192, 128) in HOPPER_DIMS
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    wq, wk, wv = torch.autograd.grad(attention_ref(*xs, causal=causal), xs,
                                     do)
    o = attention_ref(q, k, v, causal=causal)
    lse = attention_lse_ref(q, k, causal=causal)
    gq, gk, gv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                           causal=causal)
    assert gv.shape == v.shape and gk.shape == k.shape
    for got, w in ((gq, wq), (gk, wk), (gv, wv)):
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)


def test_mla_has_no_decode_path_and_counts_its_blocks():
    """An MLA config trains and prefills; its cache and decode raise, the
    dry run's decode shapes skip it, and every MLA block counts one host
    ``mla.calls``."""
    from repro_torch import tracing

    cfg = _port_cfg(SMALL)
    with pytest.raises(NotImplementedError, match="latent attention"):
        transformer.init_cache(cfg, 1, 8, device="cpu")
    ok, why = shape_applicable(cfg, SHAPES["decode_32k"])
    assert not ok and "latent" in why
    assert shape_applicable(cfg, SHAPES["prefill_32k"])[0]
    bundle, model, _, _ = _port_model(SMALL)
    n = tracing.snapshot().get("mla.calls", 0)
    logits = bundle.forward(model, _batch(SMALL))
    assert logits.shape == (2, 24, SMALL["vocab"])
    assert tracing.snapshot()["mla.calls"] == n + SMALL["n_layers"]


def test_the_cell_configuration_is_the_published_model():
    """``bench/configs/kimi-k2-5l.json`` against the port: the adapter's
    check of the reference's fields passes, the port's leaves built on
    ``meta`` are the reference's at the file's sizes, the parameter count
    is the file's, and the published config.json's numbers in the file
    are the port's published configuration's."""
    config = json.loads((ROOT / "bench/configs/kimi-k2-5l.json").read_text())
    cfg = arch_config(config)
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.q_rank, cfg.kv_rank,
            cfg.v_head_dim, cfg.d_ff) == (7168, 64, 192, 1536, 512, 128,
                                          18432)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.held) == (384, 8, 8)
    model = registry.build(cfg, device="meta").init()
    leaves = named_leaves(param_tree(model))
    specs = ref.leaf_specs(config)
    assert {n: (tuple(x.shape), x.dtype) for n, x in leaves.items()} == {
        s[0]: (tuple(s[1]), s[2]) for s in specs}
    total = sum(math.prod(s[1]) for s in specs)
    assert total == config["frozen"]["params"]
    assert cfg.num_params() + cfg.d_model == total  # the count omits ln_f
    published = get_arch("kimi-k2-instruct")
    assert published.attn_params() == 101_124_096
    assert 1.0e12 < published.num_params() < 1.05e12
    m = published.moe
    assert {k: config[k] for k in (
        "num_hidden_layers", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "q_lora_rank", "kv_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
        "intermediate_size", "moe_intermediate_size", "n_routed_experts",
        "num_experts_per_tok", "n_shared_experts", "first_k_dense_replace",
        "vocab_size", "rope_theta", "routed_scaling_factor", "rms_norm_eps",
        "scoring_func")} == {
        "num_hidden_layers": published.n_layers,
        "hidden_size": published.d_model,
        "num_attention_heads": published.n_heads,
        "num_key_value_heads": published.n_kv_heads,
        "q_lora_rank": published.q_rank, "kv_lora_rank": published.kv_rank,
        "qk_nope_head_dim": published.qk_nope_dim,
        "qk_rope_head_dim": published.qk_rope_dim,
        "v_head_dim": published.v_head_dim,
        "intermediate_size": published.d_ff, "moe_intermediate_size": m.d_ff,
        "n_routed_experts": m.n_experts, "num_experts_per_tok": m.top_k,
        "n_shared_experts": m.n_shared,
        "first_k_dense_replace": m.moe_start_layer,
        "vocab_size": published.vocab, "rope_theta": published.rope_theta,
        "routed_scaling_factor": m.route_scale,
        "rms_norm_eps": config["norm_eps"], "scoring_func": m.score_func}
    # the cut: layers, the experts held and the vocabulary, and no width
    assert set(config["reduced"]) == {"n_layers", "vocab", "moe"}
    assert {k: v for k, v in config["moe"].items()
            if getattr(m, k) != v} == {"n_held": 8}
