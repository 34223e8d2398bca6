"""Kimi Linear's mechanisms in the port, on the CPU at a small size: Kimi
Delta Attention's chunked delta rule against the token-by-token
recurrence, multi-head latent attention without a query latent or rotary
embedding, and the whole train step against the benchmark's plain f32
reference ``bench/reference/kimi_linear.py`` on seeded weights
(docs/port.md §kda). The ``cuda`` case holds one KDA layer at the
published widths to the reference's chunked form on the card
(``PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_kda.py``)
and skips without one."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from bench.apps.lm_train import arch_config, named_leaves
from bench.reference import kimi_linear as ref
from repro_torch import tracing
from repro_torch.configs import SHAPES, LinearAttnConfig, get_arch
from repro_torch.configs import shape_applicable
from repro_torch.interop import Stacked, leaf_parts, param_tree
from repro_torch.models import kda, layers, registry, transformer
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = Path(__file__).resolve().parents[1]
SEED = 2147483931

#: A small Kimi Linear: 5 layers, KDA in 1-3 and 5 (2 heads of 16,
#: convolutions of 4), NoPE MLA without a query latent in 4; the dense
#: first layer, then 16 experts of which 4 are held, top 4.
SMALL = {
    "n_layers": 5, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "vocab": 128, "sliding_window": 0, "rope_theta": 10000,
    "dtype": "float32", "router_dtype": "float32", "norm_eps": 1e-5,
    "d_ff": 96, "q_rank": 0, "kv_rank": 16, "qk_nope_dim": 8,
    "qk_rope_dim": 8, "v_head_dim": 8,
    "linear_attn_config": {"full_attn_layers": [4], "head_dim": 16,
                           "kda_layers": [1, 2, 3, 5], "num_heads": 2,
                           "short_conv_kernel_size": 4},
    "moe": {"n_experts": 16, "top_k": 4, "d_ff": 32, "n_shared": 1,
            "moe_start_layer": 1, "capacity_factor": 1.0,
            "score_func": "sigmoid", "route_scale": 2.446, "n_held": 4,
            "held_start": 4},
    "optimizer": {"lr": 0.0003, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                  "weight_decay": 0.1, "clip_norm": 1.0,
                  "state_dtype": "float32", "warmup_steps": 100,
                  "total_steps": 10000, "min_lr_frac": 0.1},
}


def _port_cfg(small: dict):
    """The port's ``kimi-linear-48b-a3b`` at ``small``'s sizes."""
    base = get_arch("kimi-linear-48b-a3b")
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "vocab", "sliding_window", "rope_theta", "dtype", "d_ff",
            "q_rank", "kv_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim",
            "norm_eps")
    la = small["linear_attn_config"]
    return dataclasses.replace(
        base, **{k: small[k] for k in keys},
        linear=LinearAttnConfig(
            n_heads=la["num_heads"], head_dim=la["head_dim"],
            conv=la["short_conv_kernel_size"],
            kda_layers=tuple(la["kda_layers"]),
            full_attn_layers=tuple(la["full_attn_layers"])),
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


def _rule_inputs(strong: bool, b=2, s=40, h=3, d=16, seed=7):
    """Inputs of the delta rule in f64: L2-normalised q and k, v, the log
    decay of ``A_log`` and gate pre-activations, β. ``strong``: A_log at
    log 16 and pre-activations ~8x larger, so that a chunk's summed decay
    runs to thousands."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    q, k = ref._l2norm(randn(b, s, h, d)), ref._l2norm(randn(b, s, h, d))
    a_log = (torch.full((h,), math.log(16.0), dtype=torch.float64) if strong
             else torch.log(1 + 15 * torch.rand(h, generator=g,
                                                dtype=torch.float64)))
    pre = randn(b, s, h, d) * 8 if strong else randn(b, s, h, d) - 3
    decay = -torch.exp(a_log)[:, None] * F.softplus(pre)
    return q, k, randn(b, s, h, d), decay, torch.sigmoid(randn(b, s, h))


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.parametrize("strong,tol", [(False, 2e-6), (True, 3e-4)])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_program_chunked_kda_equals_the_recurrence(strong, tol, chunk):
    """The program's chunked rule (:class:`~repro_torch.models.kda.KDAFn`,
    f32) against the reference's token-by-token recurrence in f64: the
    output and every input's gradient, in relative L2. ``tol``: f32
    rounding, ~3e-7 measured; under strong decay the cumulative log decay
    runs to ~-1e4, where f32 keeps differences of it to ~1e-3 absolute,
    ~3e-5 measured. Every output and gradient stays finite (no exponent
    taken is positive)."""
    xs = _rule_inputs(strong)
    want = [x.clone().requires_grad_() for x in xs]
    got = [x.float().requires_grad_() for x in xs]
    o_want = ref.kda_recurrent(*want)
    o = kda.KDAFn.apply(*got, chunk)
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    assert _rel(o, o_want) < tol
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    g_want = torch.autograd.grad(o_want, want, do)
    g_got = torch.autograd.grad(o, got, do.float())
    for name, a, b in zip("q k v g beta".split(), g_got, g_want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) < 2 * tol, name


@pytest.mark.parametrize("strong", [False, True])
def test_reference_chunked_kda_equals_its_recurrence(strong):
    """The reference's own chunked form (chunks of 32, each pair's decay
    whole, the UT transform by ``solve_triangular``) against its
    token-by-token definition, in f64 to rounding, with its gradients."""
    xs = [x.requires_grad_() for x in _rule_inputs(strong)]
    o, want = ref.kda_chunked(*xs), ref.kda_recurrent(*xs)
    assert _rel(o, want) < 1e-10
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(o, xs, do),
                    torch.autograd.grad(want, xs, do)):
        assert _rel(a, b) < 1e-10


def test_a_short_sequence_is_one_chunk():
    """A sequence shorter than the chunk runs as one chunk padded to whole
    sub-chunks; the padding changes nothing."""
    xs = [x.float() for x in _rule_inputs(False, s=13)]
    o = kda.kda_chunked(*xs, chunk=64)
    assert o.shape == (2, 13, 3, 16)
    torch.testing.assert_close(o, kda.kda_chunked(*xs, chunk=8), rtol=1e-5,
                               atol=1e-6)


def test_the_reference_imports_no_jax_and_no_port_kernel():
    """``bench.reference.kimi_linear`` imports from the root, and brings
    in neither JAX nor anything of the port."""
    code = ("import sys; import bench.reference.kimi_linear; print(sorted("
            "m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', "
            "'repro_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("norm_eps", [1e-5, 0.05])
def test_port_equals_the_reference_loss_gradients_and_step(norm_eps):
    """The port's loss, every leaf's gradient, and one AdamW step against
    the reference's, both in f32 on the same weights and tokens (80 a
    sequence: two chunks of the program's delta rule): KDA layers dense
    and with experts, a NoPE MLA layer with the direct query, the held
    slice [4, 8) of 16 experts under a capacity that drops.
    ``norm_eps`` 0.05 shows that every RMSNorm reads the config's epsilon.
    Tolerances as ``test_torch_mla.py``'s: another order of the same f32
    operations, ~1e-6 relative, grown ≤ ~10x by the backward; rtol 1e-4 on
    the gradients, 1e-5 on the loss, 1e-3 on each leaf's change."""
    small = {**SMALL, "norm_eps": norm_eps}
    bundle, model, leaves, specs = _port_model(small)
    assert {n.split(".")[0] for n in leaves} >= {
        "kda_layers", "kda_moe_layers", "moe_layers"}
    batch = _batch(small, seq=80)
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
    want_loss, dropped = ref.loss(p, batch, small)
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

    opt_cfg = AdamWConfig(**small["optimizer"])
    state = init_state(opt_cfg, param_tree(model))
    model, state, metrics = bundle.make_train_step(opt_cfg)(model, state,
                                                            batch)
    torch.testing.assert_close(metrics["loss"], want_loss.detach(),
                               rtol=1e-5, atol=0)
    out = ref.train(small, SEED, [{k: v.numpy() for k, v in batch.items()}],
                    "cpu")
    leaves = named_leaves(param_tree(model))
    for i, spec in enumerate(specs):
        leaf = leaves[spec[0]]
        cur = leaf.stack() if isinstance(leaf, Stacked) else leaf.detach()
        change = (cur - ref.draw(spec, SEED, i, "cpu")).norm().item()
        assert math.isclose(change, out["change_norm"][spec[0]],
                            rel_tol=1e-3, abs_tol=1e-9), spec[0]


def test_the_reference_loss_by_recurrence_equals_by_chunks():
    """The reference's loss with KDA as the token-by-token definition and
    as its chunked form, on the same weights: to f32 rounding."""
    p = {s[0]: ref.draw(s, SEED, i, "cpu")
         for i, s in enumerate(ref.leaf_specs(SMALL))}
    batch = _batch(SMALL)
    chunked, _ = ref.loss(p, batch, SMALL)
    recurrent, _ = ref.loss(p, batch, SMALL, rule=ref.kda_recurrent)
    torch.testing.assert_close(chunked, recurrent, rtol=1e-6, atol=0)


def test_dropping_the_erase_term_moves_the_loss_past_the_tolerance():
    """The delta rule without its erase term (S_t = Diag(α_t) S_{t−1} +
    β_t k_t v_tᵀ, gated linear attention) moves the reference's loss by
    more than the rtol 1e-5 that the port is held to above."""
    def no_erase(q, k, v, g, beta):
        b, s, h, dk = k.shape
        state = q.new_zeros((b, h, dk, v.shape[-1]))
        out = []
        for t in range(s):
            state = (torch.exp(g[:, t])[..., None] * state
                     + (beta[:, t, :, None] * k[:, t])[..., None]
                     * v[:, t, :, None, :])
            out.append(torch.einsum("bhkv,bhk->bhv", state,
                                    q[:, t] * dk ** -0.5))
        return torch.stack(out, 1)

    p = {s[0]: ref.draw(s, SEED, i, "cpu")
         for i, s in enumerate(ref.leaf_specs(SMALL))}
    batch = _batch(SMALL)
    want, _ = ref.loss(p, batch, SMALL, rule=ref.kda_recurrent)
    broken, _ = ref.loss(p, batch, SMALL, rule=no_erase)
    assert abs(broken - want) / want > 1e-4


def _moe_module(cfg, p, pre, i, start, held):
    """The port's MoE of layer ``i`` of group ``pre`` of the reference's
    weights ``p``, holding experts ``[start, start + held)``."""
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_held=held, held_start=start))
    moe = layers.MoE(cfg, device="cpu")
    m = pre + "moe."
    with torch.no_grad():
        moe.router.copy_(p[m + "router"][i])
        moe.select_bias.copy_(p[m + "select_bias"][i])
        for w in ("w_gate", "w_up", "w_down"):
            getattr(moe, w).copy_(p[m + w][i, start:start + held])
            getattr(moe.shared, w).copy_(p[m + "shared." + w][i])
    return cfg, moe


@pytest.mark.parametrize("pre", ["kda_moe_layers.", "moe_layers."])
def test_held_slices_and_the_shared_expert_sum_to_the_uncut_layer(pre):
    """As ``test_torch_mla.py``'s share test, at Kimi Linear's routing
    (gates × 2.446) in a KDA and an MLA layer's experts: over slices that
    tile the 16 experts (4 cards of 4, 2 of 8), each card's held part,
    with the shared expert counted once, adds up to the uncut layer of the
    reference at a capacity that drops nothing (cf = E / k). rtol 1e-5:
    the parts sum in another order."""
    small = json.loads(json.dumps(SMALL))
    small["moe"].update(n_held=16, held_start=0, capacity_factor=4.0)
    cfg = _port_cfg(small)
    p = {s[0]: ref.draw(s, SEED, i, "cpu")
         for i, s in enumerate(ref.leaf_specs(small))}
    h = torch.randn((2, 24, small["d_model"]),
                    generator=torch.Generator().manual_seed(3))
    want, drops = ref.experts(p, pre, 0, h, small, torch.matmul)
    assert int(drops) == 0
    _, whole = _moe_module(cfg, p, pre, 0, 0, 16)
    torch.testing.assert_close(layers.moe_apply(whole, h, cfg), want,
                               rtol=1e-5, atol=1e-6)
    shared = layers.mlp_apply(whole.shared, h.reshape(-1, h.shape[-1]),
                              cfg).reshape(h.shape)
    for held in (4, 8):
        total = shared.clone()
        for start in range(0, 16, held):
            c, moe = _moe_module(cfg, p, pre, 0, start, held)
            total += layers.moe_apply(moe, h, c) - shared
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def test_kda_has_no_decode_path():
    """A config with KDA trains and prefills; its cache and decode raise
    with KDA named, and the dry run's decode shapes skip it."""
    cfg = _port_cfg(SMALL)
    with pytest.raises(NotImplementedError, match="Kimi Delta Attention"):
        transformer.init_cache(cfg, 1, 8, device="cpu")
    ok, why = shape_applicable(cfg, SHAPES["decode_32k"])
    assert not ok and "Kimi Delta Attention" in why
    assert shape_applicable(cfg, SHAPES["train_4k"])[0]


def test_kda_calls_count_twenty_a_forward_at_full_depth():
    """At the published widths and depth, on ``meta`` (nothing allocated):
    one forward counts 20 host ``kda.calls`` (the KDA layers) and 7
    ``mla.calls``, and the logits have the vocabulary's width."""
    cfg = dataclasses.replace(get_arch("kimi-linear-48b-a3b"), vocab=512)
    bundle = registry.build(cfg, device="meta")
    model = bundle.init()
    before = tracing.snapshot()
    tokens = torch.zeros((1, 64), dtype=torch.int64, device="meta")
    out = transformer.forward(model, tokens)
    after = tracing.snapshot()
    assert out.shape == (1, 64, 512)
    assert after["kda.calls"] - before.get("kda.calls", 0) == 20
    assert after["mla.calls"] - before.get("mla.calls", 0) == 7


def test_the_published_configuration_counts():
    """The port's ``kimi-linear-48b-a3b``: every layer of the published
    pattern, the widths of config.json, ~48 B parameters of which ~3 B
    active, MLA's heads derived as 128 + 64; and the benchmark's file
    against it: the catalog's numbers, the cut (the vocabulary and the
    experts held alone), and its frozen parameter count."""
    cfg = get_arch("kimi-linear-48b-a3b")
    la = cfg.linear
    assert [i + 1 for i in range(27) if cfg.is_kda(i)] == list(la.kda_layers)
    assert sorted(la.kda_layers + la.full_attn_layers) == list(range(1, 28))
    assert cfg.head_dim == 192 and cfg.q_rank == 0 and not cfg.use_rope
    assert cfg.kda_params() == 39_514_272
    assert cfg.attn_params() == 29_114_880
    assert 48e9 < cfg.num_params() < 50e9
    assert 3.0e9 < cfg.active_params() < 3.6e9
    config = json.loads(
        (ROOT / "bench/configs/kimi-linear-27l.json").read_text())
    published = {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads, "intermediate_size": cfg.d_ff,
        "kv_lora_rank": cfg.kv_rank, "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "moe_intermediate_size": cfg.moe.d_ff,
        "num_experts": cfg.moe.n_experts,
        "num_experts_per_token": cfg.moe.top_k,
        "num_shared_experts": cfg.moe.n_shared,
        "first_k_dense_replace": cfg.moe.moe_start_layer,
        "routed_scaling_factor": cfg.moe.route_scale,
        "rms_norm_eps": cfg.norm_eps, "vocab_size": cfg.vocab,
        "q_lora_rank": None, "mla_use_nope": True,
        "linear_attn_config": {
            "full_attn_layers": list(la.full_attn_layers),
            "head_dim": la.head_dim, "kda_layers": list(la.kda_layers),
            "num_heads": la.n_heads, "short_conv_kernel_size": la.conv}}
    assert {k: config[k] for k in published} == published
    run = arch_config(config)
    assert run.head_dim == 192 and run.norm_eps == 1e-5
    assert set(config["reduced"]) == {"vocab", "moe"}
    assert {k: v for k, v in config["moe"].items()
            if getattr(cfg.moe, k) != v} == {"n_held": 8}
    assert run.num_params() + run.d_model == config["frozen"]["params"]
    assert sum(math.prod(s[1]) for s in ref.leaf_specs(config)) == \
        config["frozen"]["params"]


@pytest.mark.cuda
def test_one_kda_layer_at_the_published_widths_on_the_card():
    """On the card, at T 8,192 and all 32 heads of 128 (B 1): the
    program's chunked rule (KDAFn, chunks of 64) against the reference's
    chunked form in f32 on the same inputs (a layer's q, k, v, decay and
    β from random projections of the published widths): the output and
    the gradients of q, k, v, g and β, each within 1e-4 in relative L2
    (both f32; another order and chunking of the same sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    b, s, h, d = 1, 8192, 32, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, k = ref._l2norm(randn(b, s, h, d)), ref._l2norm(randn(b, s, h, d))
    a_log = torch.log(1 + 15 * torch.rand(h, generator=g, device=dev))
    decay = -torch.exp(a_log)[:, None] * F.softplus(randn(b, s, h, d) - 3)
    xs = (q, k, randn(b, s, h, d), decay, torch.sigmoid(randn(b, s, h)))
    do = randn(b, s, h, d)
    outs = {}
    for name, fn in (("program", lambda *x: kda.KDAFn.apply(*x, 64)),
                     ("reference", ref.kda_chunked)):
        ins = [x.clone().requires_grad_() for x in xs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        o = fn(*ins)
        grads = torch.autograd.grad(o, ins, do)
        torch.cuda.synchronize()
        outs[name] = (o.detach(), grads,
                      torch.cuda.max_memory_allocated() / 1e9)
    (o, gp, peak), (o_ref, gr, peak_ref) = outs["program"], outs["reference"]
    rel = {"o": _rel(o, o_ref)}
    rel.update({n: _rel(a, b) for n, a, b in zip(
        ("dq", "dk", "dv", "dg", "dbeta"), gp, gr)})
    print(f"KDA layer, T {s}, {h} heads: rel L2 {rel}; peak GB program "
          f"{peak:.2f}, reference {peak_ref:.2f}")
    assert all(v < 1e-4 for v in rel.values()), rel
