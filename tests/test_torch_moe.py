"""The port's mixture of experts (``models/layers.py::moe_apply``, the MoE
layers of ``models/transformer.py``, the ``"moe"`` bundle and
``interop.params_from_jax`` for the MoE tree) against the JAX package on
the CPU, at reduced Mixtral-8x7B (every layer MoE, a sliding window) and
reduced Kimi K2 (one dense layer, then MoE with the shared expert).

Every comparison is f32 on the same numpy inputs, with the JAX weights
carried across. The capacity factor is swept: 8.0 (the reduced config's,
nothing drops), 1.25 (the published one) and 0.75, where the tests assert
that the dispatch dropped assignments, so the reference's drop order is
held, not only its no-drop path. Tolerances: one MoE block rtol 1e-5
(atol 1e-6, at values of order 1); logits after two layers and the head
1e-4, as ``tests/test_torch_lm.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Request, ServeEngine

MOE = ("mixtral-8x7b", "kimi-k2-1t-a32b")
#: One MoE block, f32: the same products summed in another order.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
#: Logits after two layers and the head, f32 (tests/test_torch_lm.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: The same rows' step inside a batch of another size, f32: torch's
#: matmuls block the batch differently (observed up to 2.4e-6).
ROWS_TOL = dict(rtol=1e-5, atol=1e-5)
#: Capacity factors: the reduced config's (no drop), the published one,
#: and one that drops.
DROPS = 0.75


def _cfgs(name, cf=None):
    """The reduced config of ``name`` in both packages, at capacity
    factor ``cf`` (the reduced config's own when ``None``)."""
    out = []
    for get in (jax_get_arch, get_arch):
        c = get(name).reduced()
        if cf is not None:
            c = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
        out.append(c)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(name):
    """The JAX params of ``name``'s reduced config (seed 0), and as numpy."""
    jc = _cfgs(name)[0]
    params = jax.jit(lambda k: jt.init_params(jc, k))(jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _models(name, cf=None):
    """Both configs, the JAX params and the port's model holding them;
    the capacity factor does not change the weights."""
    jc, tc = _cfgs(name, cf)
    params, tree = _params(name)
    return jc, tc, params, params_from_jax(tree, tc, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _moe_block(params, model, i=0):
    """Stacked MoE layer ``i``: the JAX sub-tree and the port's module."""
    jp = jax.tree_util.tree_map(lambda a: a[i], params["moe_layers"]["moe"])
    return jp, [x for x in model.layers if hasattr(x, "moe")][i].moe


@pytest.mark.parametrize("cf", [None, 1.25, DROPS])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_equals_the_reference(name, cf):
    jc, tc, params, model = _models(name, cf)
    jp, moe = _moe_block(params, model)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32)
    got = tl.moe_apply(moe, torch.from_numpy(x), tc)
    want = jl.moe_apply(jp, jnp.asarray(x), jc)
    _close(got, want, BLOCK_TOL)
    keep = tl.moe_route(moe, torch.from_numpy(x).reshape(-1, tc.d_model),
                        tc)[3]
    if cf == DROPS:
        assert not keep.all(), "the dropping case must drop"
        ample = tl.moe_apply(moe, torch.from_numpy(x), _cfgs(name)[1])
        assert not torch.allclose(got, ample, **BLOCK_TOL)
    elif cf is None:
        assert keep.all()


@pytest.mark.parametrize("name", MOE)
def test_route_is_the_references_drop_order(name):
    """The top-k experts are the reference's, and each assignment's place
    in its expert is its rank among the assignments to that expert in
    token-major order (a numpy count, independent of the port); exactly
    those below ``cap`` are kept."""
    jc, tc, params, model = _models(name, DROPS)
    jp, moe = _moe_block(params, model)
    x = np.random.default_rng(2).standard_normal(
        (3, 8, tc.d_model)).astype(np.float32)
    xt = x.reshape(-1, tc.d_model)
    gates, idx, pos, keep, cap = tl.moe_route(moe, torch.from_numpy(xt), tc)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], -1)
    jg, jidx = jax.lax.top_k(probs, jc.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, np.asarray(jg) / np.asarray(jg).sum(-1, keepdims=True),
           BLOCK_TOL)
    flat = np.asarray(jidx).reshape(-1)
    seen: dict = {}
    want = []
    for e in flat:
        want.append(seen.get(int(e), 0))
        seen[int(e)] = want[-1] + 1
    np.testing.assert_array_equal(pos.numpy(), want)
    assert cap == int(max(2, DROPS * 24 * 2 / 4))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want) < cap)
    assert not keep.all()


@pytest.mark.parametrize("name", MOE)
def test_params_from_jax_carries_the_moe_tree(name):
    """Every JAX leaf lands in its parameter: dense head layers from
    ``layers`` (Kimi's first), then ``moe_layers`` with the router, the
    experts and Kimi's shared expert."""
    jc, tc, params, model = _models(name)
    n_dense = tc.moe.moe_start_layer
    assert len(model.layers) == tc.n_layers
    assert ("layers" in params) == (n_dense > 0)
    n = 0
    for i, layer in enumerate(model.layers):
        group, j = (("layers", i) if i < n_dense
                    else ("moe_layers", i - n_dense))
        assert hasattr(layer, "moe") == (group == "moe_layers")
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                params[group])[0]:
            mod = layer
            for k in path:
                mod = getattr(mod, k.key)
            np.testing.assert_array_equal(mod.numpy(), np.asarray(leaf)[j])
            n += 1
    assert hasattr(model.layers[-1].moe, "shared") == bool(tc.moe.n_shared)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert n == len([p for p in model.layers.parameters()])


@pytest.mark.parametrize("cf", [None, DROPS])
@pytest.mark.parametrize("name", MOE)
def test_forward_logits(name, cf):
    jc, tc, params, model = _models(name, cf)
    tokens = np.random.default_rng(3).integers(
        0, tc.vocab, (2, 24)).astype(np.int32)
    got = tt.forward(model, torch.from_numpy(tokens).long())
    want = jax.jit(jt.forward, static_argnums=1)(params, jc,
                                                 jnp.asarray(tokens))
    assert got.shape == (2, 24, tc.vocab)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("name", MOE)
def test_decode_steps_equal_the_reference(name, monkeypatch):
    """Three full-batch ``decode_step``s (``rows=None``, the reference's
    step) on 8 rows at the dropping capacity: logits at every step and
    both caches equal JAX's, and the steps did drop assignments."""
    jc, tc, params, model = _models(name, DROPS)
    dropped = []
    route = tl.moe_route

    def counting(*a):
        out = route(*a)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(tl, "moe_route", counting)
    tokens = np.random.default_rng(4).integers(
        0, tc.vocab, (8, 3)).astype(np.int32)
    cache = tt.init_cache(tc, 8, 8, "cpu")
    jcache = jt.init_cache(jc, 8, 8)
    step = jax.jit(lambda p, t, c, pos: jt.decode_step(p, jc, t, c, pos))
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        lg, cache = tt.decode_step(model, torch.from_numpy(tok).long(),
                                   cache, pos)
        jlg, jcache = step(params, jnp.asarray(tok), jcache,
                           jnp.asarray(pos, jnp.int32))
        _close(lg, jlg, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    _close(cache["v"], jcache["v"], MODEL_TOL)
    assert sum(dropped) > 0


@pytest.mark.parametrize("name", MOE)
def test_engine_steps_equal_decode_step_on_the_live_rows(name):
    """The engine passes the rows it steps, and an MoE step dispatches
    those rows alone: its capacity counts the live rows' tokens, where
    the JAX ``ServeEngine`` steps (and dispatches) the full batch. Every
    engine step, at the dropping capacity with three slots, equals the
    port's ``decode_step`` on a batch of just the live rows (their
    tokens and cache rows), in logits and in the cache rows written."""
    _, tc, _, model = _models(name, DROPS)
    bundle = registry.build(tc, device="cpu")
    calls = []
    decode = bundle.decode

    def recording(m, tok, cache, pos, rows=None):
        before = {k: v[:, rows].clone() for k, v in cache.items()}
        lg, cache = decode(m, tok, cache, pos, rows)
        calls.append((tok[rows].clone(), pos, list(rows), before,
                      lg[rows].clone(),
                      {k: v[:, rows].clone() for k, v in cache.items()}))
        return lg, cache

    bundle.decode = recording
    eng = ServeEngine(bundle, model, max_batch=3, max_seq=32)
    for rid, p in enumerate([[5, 17, 31], [7, 2, 44], [9, 3, 8], [4, 6]]):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
    done = eng.run_until_drained()
    assert sorted(len(c.tokens) for c in done) == [4] * 4
    assert max(len(c[2]) for c in calls) == 3  # lockstep replay of three
    for tok, pos, rows, before, lg, after in calls:
        cache = {k: v.clone() for k, v in before.items()}
        want, cache = tt.decode_step(model, tok, cache, pos)
        torch.testing.assert_close(lg, want, **ROWS_TOL)
        for k in cache:
            torch.testing.assert_close(after[k], cache[k], **ROWS_TOL)


def _greedy_ok(tokens, prompt, logits_of):
    seq = list(prompt)
    for t in tokens:
        if t != int(np.argmax(logits_of(seq))):
            return False
        seq.append(t)
    return True


@pytest.mark.parametrize("max_batch", [2, 3])
@pytest.mark.parametrize("name", MOE)
def test_engine_equals_greedy_forward_without_drops(name, max_batch):
    """With a capacity factor of E/k no assignment can drop (``cap`` is
    then at least the number of tokens, and a token picks an expert at
    most once), so a token's output no longer depends on which tokens
    share its dispatch and the engine can be held to the greedy forward,
    of the port's and of the reference's model. This isolates the cache
    logic from the dispatch; the drop path is held by the tests above."""
    cf = get_arch(name).reduced().moe.n_experts / 2  # E / k, k = 2 reduced
    jc, tc, params, model = _models(name, cf)
    bundle = registry.build(tc, device="cpu")
    eng = ServeEngine(bundle, model, max_batch=max_batch, max_seq=32)
    prompts = {rid: [1 + rid, 2, 3] for rid in range(4)}
    for rid, p in prompts.items():
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=4))
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    fwd = jax.jit(jreg.build(jc).forward)
    port = lambda seq: bundle.forward(  # noqa: E731
        model, {"tokens": torch.tensor([seq])})[0, -1].numpy()
    ref = lambda seq: np.asarray(fwd(  # noqa: E731
        params, {"tokens": jnp.asarray([seq], jnp.int32)})[0, -1])
    for c in done:
        assert len(c.tokens) == 4
        assert _greedy_ok(c.tokens, prompts[c.rid], port)
        assert _greedy_ok(c.tokens, prompts[c.rid], ref)


def test_rows_leave_the_other_rows_untouched():
    """``rows`` writes K/V only into the listed rows, and the listed
    rows' logits do not depend on the other rows' tokens."""
    _, tc, _, model = _models("kimi-k2-1t-a32b", DROPS)
    tok = torch.tensor([[3], [4], [5], [6]])
    other = torch.tensor([[9], [4], [11], [12]])
    a = tt.init_cache(tc, 4, 8, "cpu")
    b = tt.init_cache(tc, 4, 8, "cpu")
    lg_a, _ = tt.decode_step(model, tok, a, 2, rows=[1])
    lg_b, _ = tt.decode_step(model, other, b, 2, rows=[1])
    assert torch.equal(lg_a[1], lg_b[1])
    for key in ("k", "v"):
        assert torch.equal(a[key], b[key])
        assert not a[key][:, [0, 2, 3]].any() and a[key][:, 1].any()


@pytest.mark.parametrize("name", MOE)
def test_serve_launcher_on_the_cpu(name, capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", name, "--device", "cpu", "--requests", "3",
                 "--new-tokens", "3", "--max-batch", "2"])
    assert sorted(len(c.tokens) for c in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert f"{name} (reduced: " in out and "3 completions, 9 tokens" in out
