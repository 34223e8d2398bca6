"""The port's LM substrate (``repro_torch.configs``, ``models``) against
the JAX package's on the CPU: the same numpy inputs, and JAX-initialized
parameters carried across by ``interop.params_from_jax``.

Every comparison is f32 at the reduced configs: the port runs the same
operations as the reference and differs only in the order XLA and torch
sum in, so each tolerance is a small multiple of f32 rounding at the
values' scale, stated where it is used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import ARCHS, get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import registry
from repro_torch.models import transformer as tt

#: One layer's activations, f32 (norm, rope, projections).
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: Logits after two layers and the head, f32.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: Decode against prefill of the same model (tests/test_archs.py).
CONSISTENCY_TOL = dict(rtol=5e-2, atol=5e-2)

DENSE = sorted(n for n, c in ARCHS.items() if c.family == "dense")


def _cfgs(name, **changes):
    """The reduced config of ``name`` in both packages."""
    jc = dataclasses.replace(jax_get_arch(name).reduced(), **changes)
    tc = dataclasses.replace(get_arch(name).reduced(), **changes)
    return jc, tc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(name, window=0):
    """Both configs, the JAX params (seed 0) and the port's model holding
    them; cached, since JAX's init dominates these tests' time."""
    jc, tc = _cfgs(name, sliding_window=window) if window else _cfgs(name)
    params = jax.jit(lambda k: jt.init_params(jc, k))(jax.random.PRNGKey(0))
    return jc, tc, params, params_from_jax(_np_tree(params), tc, "cpu")


def _layer0(params, key):
    return jax.tree_util.tree_map(lambda x: x[0], params["layers"][key])


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen3-8b")


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s)), LAYER_TOL)


@pytest.mark.parametrize("pos_dims", [1, 2])
def test_apply_rope_interleaved_pairs(rng, pos_dims):
    x = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    pos = (np.arange(7) + 3 if pos_dims == 1
           else rng.integers(0, 2048, (2, 7))).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    # angles up to 2048 rad: cos/sin of f32 arguments round differently
    _close(got, want, dict(rtol=1e-4, atol=1e-4))
    # the rotated pair is (x[0::2], x[1::2]), not rotate_half's halves
    y = torch.zeros((1, 1, 1, 4))
    y[..., 1] = 1.0
    r = tl.apply_rope(y, torch.tensor([1]), 1.0)[0, 0, 0]
    assert abs(float(r[0]) + np.sin(1.0)) < 1e-6
    assert abs(float(r[1]) - np.cos(1.0)) < 1e-6


def test_attn_qkv(qwen, rng):
    jc, tc, params, model = qwen
    x = rng.standard_normal((2, 6, tc.d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    got = tl.attn_qkv(model.layers[0].attn, torch.from_numpy(x), tc,
                      torch.from_numpy(pos))
    want = jax.jit(jl.attn_qkv, static_argnums=2)(
        _layer0(params, "attn"), jnp.asarray(x), jc, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply(rng, act):
    jc, tc = _cfgs("qwen3-8b", activation=act)
    p = jl.mlp_init(jax.random.PRNGKey(3), jc)
    mlp = tl.MLP(tc)
    for name, value in p.items():
        getattr(mlp, name).data.copy_(torch.from_numpy(np.array(value)))
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    _close(tl.mlp_apply(mlp, torch.from_numpy(x), tc),
           jl.mlp_apply(p, jnp.asarray(x), jc), LAYER_TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention(rng, window):
    jc, tc, params, model = _models("qwen3-8b", window)
    shape = (2, tc.n_kv_heads, 12, tc.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, tk, tv = tl.decode_attention(model.layers[0].attn,
                                      torch.from_numpy(x), tc, tk, tv, 7)
    jo, jk, jv = jax.jit(jl.decode_attention, static_argnums=(2, 5))(
        _layer0(params, "attn"), jnp.asarray(x), jc, jnp.asarray(ck),
        jnp.asarray(cv), 7)
    _close(out, jo, LAYER_TOL)
    _close(tk, jk, LAYER_TOL)
    _close(tv, jv, LAYER_TOL)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-8b+window",
                                  "qwen2.5-32b", "granite-34b",
                                  "nemotron-4-15b"])
def test_forward_logits(name, rng):
    """qk-norm, a sliding window, qkv biases, MQA with GELU (granite) and
    squared ReLU with GQA 6 (nemotron), each whole model against JAX's."""
    arch, _, extra = name.partition("+")
    jc, tc, params, model = _models(arch, 8 if extra else 0)
    tokens = rng.integers(0, tc.vocab, (2, 24)).astype(np.int32)
    got = tt.forward(model, torch.from_numpy(tokens).long())
    want = jax.jit(jt.forward, static_argnums=1)(params, jc,
                                                 jnp.asarray(tokens))
    assert got.shape == (2, 24, tc.vocab)
    _close(got, want, MODEL_TOL)


def test_prefill_step(qwen, rng):
    jc, tc, params, model = qwen
    tokens = rng.integers(0, tc.vocab, (3, 16)).astype(np.int32)
    got = registry.build(tc, device="cpu").make_prefill_step()(
        model, {"tokens": torch.from_numpy(tokens).long()})
    jb = jreg.build(jc)
    want = jax.jit(jb.make_prefill_step())(params,
                                           {"tokens": jnp.asarray(tokens)})
    assert got.shape == (3, tc.vocab)
    _close(got, want, MODEL_TOL)


def test_decode_step_with_cache(qwen, rng):
    """16 positions of ``decode_step`` (every row written, the reference's
    step): logits and both caches equal JAX's at every position."""
    jc, tc, params, model = qwen
    tokens = rng.integers(0, tc.vocab, (2, 16)).astype(np.int32)
    cache = tt.init_cache(tc, 2, 16, "cpu")
    jcache = jt.init_cache(jc, 2, 16)
    step = jax.jit(lambda p, t, c, pos: jt.decode_step(p, jc, t, c, pos))
    for pos in range(16):
        tok = tokens[:, pos:pos + 1]
        lg, cache = tt.decode_step(model, torch.from_numpy(tok).long(),
                                   cache, pos)
        jlg, jcache = step(params, jnp.asarray(tok), jcache,
                           jnp.asarray(pos, jnp.int32))
        _close(lg, jlg, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    _close(cache["v"], jcache["v"], MODEL_TOL)


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_prefill(name):
    """Prefill logits at position t equal step-by-step decode
    (tests/test_archs.py::test_decode_step_runs_and_is_causal_consistent)."""
    tc = get_arch(name).reduced()
    bundle = registry.build(tc, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, tc.vocab, (2, 16))).long()
    full = bundle.forward(model, {"tokens": tokens})
    cache = bundle.cache_init(2, 16)
    steps = []
    for t in range(16):
        lg, cache = bundle.make_decode_step()(model, tokens[:, t:t + 1],
                                              cache, t)
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, full, **CONSISTENCY_TOL)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_num_params_matches_reference(name):
    """The counts of every arch equal the reference's, full and reduced:
    the analytic ones, and the hybrid's and the SSM's, which count the
    parameters of a meta-device model (6,750,840,528 for zamba2-7b,
    190,738,176 for xlstm-125m)."""
    for jc, tc in ((jax_get_arch(name), get_arch(name)),
                   (jax_get_arch(name).reduced(), get_arch(name).reduced())):
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
        assert tc.param_dtype == getattr(torch, jc.dtype)


def test_init_shapes_count_and_distribution():
    """A seeded init fills exactly ``num_params`` parameters, with the
    reference's distributions."""
    tc = get_arch("qwen3-8b").reduced()
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(
        tc.num_params(), rel=0.05)
    assert abs(float(model.embed.std()) - 0.02) < 2e-3
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) * tc.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(model.layers[1].attn.q_norm,
                       torch.ones(tc.head_dim))


def test_cross_entropy(rng):
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = -100
    got = tl.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels).long())
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_build_raises_for_an_unknown_family():
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(),
                              family="conv")
    with pytest.raises(ValueError, match="unknown family 'conv'"):
        registry.build(cfg, device="cpu")
