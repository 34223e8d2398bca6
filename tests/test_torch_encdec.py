"""The port's encoder-decoder path (whisper-medium, reduced) and the model
inputs of a shape cell against the JAX package on the CPU: the same numpy
inputs, and JAX-initialized parameters carried across by
``interop.params_from_jax``.

Every comparison is f32 at the reduced config (2 + 2 layers, d_model 128,
4 heads at D 32): the port runs the same operations as the reference and
differs only in the order XLA and torch sum in, so each tolerance is a
small multiple of f32 rounding at the values' scale, stated where it is
used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import ServeEngine

#: One layer's activations, f32 (norms, projections).
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: Encoder states and logits after two (+ two) layers and the head, f32.
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

FRAMES, TOKENS = 32, 8  # the repo's frames / 4 rule (DESIGN.md §Shapes)


@functools.lru_cache(maxsize=None)
def _whisper():
    """Both reduced configs, the JAX params (seed 0) and the port's model
    holding them."""
    jc = jax_get_arch("whisper-medium").reduced()
    tc = get_arch("whisper-medium").reduced()
    params = jax.jit(lambda k: jt.init_params(jc, k))(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, params_from_jax(tree, tc, "cpu")


def _inputs(seed, b=2, frames=FRAMES, tokens=TOKENS, d=128, vocab=512):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, frames, d)).astype(np.float32),
            rng.integers(0, vocab, (b, tokens)).astype(np.int32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    _close(tl.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))),
           jl.layer_norm(*(jnp.asarray(a) for a in (x, s, b))), LAYER_TOL)


def test_encode():
    jc, tc, params, model = _whisper()
    frames, _ = _inputs(1)
    got = tt.encode(model, torch.from_numpy(frames))
    want = jax.jit(jt.encode, static_argnums=1)(params, jc,
                                                jnp.asarray(frames))
    assert got.shape == (2, FRAMES, tc.d_model)
    _close(got, want, MODEL_TOL)


def test_forward_enc_dec():
    """Ragged lengths (36 frames, 9 tokens) through the bundle's forward."""
    jc, tc, params, model = _whisper()
    frames, tokens = _inputs(2, frames=36, tokens=9)
    got = registry.build(tc, device="cpu").forward(
        model, {"frames": torch.from_numpy(frames),
                "tokens": torch.from_numpy(tokens)})
    want = jax.jit(jt.forward_enc_dec, static_argnums=1)(
        params, jc, jnp.asarray(frames), jnp.asarray(tokens))
    assert got.shape == (2, 9, tc.vocab)
    _close(got, want, MODEL_TOL)


def test_prime_cross_cache():
    """Every layer's cross K/V from the encoder states, no rope: (L, B,
    Hkv, T, D), the self caches untouched."""
    jc, tc, params, model = _whisper()
    enc = np.random.default_rng(3).standard_normal(
        (2, FRAMES, tc.d_model)).astype(np.float32)
    cache = tt.init_cache(tc, 2, TOKENS, "cpu")
    assert cache["xk"].shape == (tc.n_layers, 2, tc.n_kv_heads, 4 * TOKENS,
                                 tc.head_dim)
    got = tt.prime_cross_cache(model, cache, torch.from_numpy(enc))
    want = jax.jit(jt.prime_cross_cache, static_argnums=1)(
        params, jc, jt.init_cache(jc, 2, TOKENS), jnp.asarray(enc))
    for key in ("xk", "xv"):
        _close(got[key], want[key], LAYER_TOL)
    assert got["k"] is cache["k"] and got["v"] is cache["v"]


@pytest.mark.parametrize("path", ["primed", "slow"])
def test_decode_step_enc_dec(path):
    """One step at position 5 against a self cache of random K/V: on a
    primed cache, and on the slow path (a cache without ``xk``, primed
    from ``enc_states`` inside the step). Logits and both self caches
    equal JAX's; the step writes K/V only at ``pos``."""
    jc, tc, params, model = _whisper()
    rng = np.random.default_rng(4)
    shape = (tc.n_layers, 2, tc.n_kv_heads, TOKENS, tc.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    enc = rng.standard_normal((2, FRAMES, tc.d_model)).astype(np.float32)
    tok = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    if path == "primed":
        cache = tt.prime_cross_cache(model, cache, torch.from_numpy(enc))
        jcache = jt.prime_cross_cache(params, jc, jcache, jnp.asarray(enc))
    lg, cache = tt.decode_step_enc_dec(model, torch.from_numpy(tok), cache,
                                       5, torch.from_numpy(enc))
    jlg, jcache = jax.jit(jt.decode_step_enc_dec, static_argnums=1)(
        params, jc, jnp.asarray(tok), jcache, jnp.asarray(5, jnp.int32),
        jnp.asarray(enc))
    assert lg.shape == (2, 1, tc.vocab)
    _close(lg, jlg, MODEL_TOL)
    for key in ("k", "v", "xk", "xv"):
        _close(cache[key], jcache[key], MODEL_TOL)
    others = [p for p in range(TOKENS) if p != 5]
    assert np.array_equal(cache["k"][:, :, :, others].numpy(),
                          ck[:, :, :, others])


def test_decode_matches_forward():
    """Teacher-forced decode after ``prime_cross_cache`` equals the
    forward at every position (tests/test_archs.py's consistency check,
    here at f32 rounding: the two paths run the same operations)."""
    jc, tc, params, model = _whisper()
    bundle = registry.build(tc, device="cpu")
    frames, tokens = _inputs(5, frames=64, tokens=16)
    frames, tokens = torch.from_numpy(frames), torch.from_numpy(tokens)
    full = bundle.forward(model, {"frames": frames, "tokens": tokens})
    cache = tt.prime_cross_cache(model, bundle.cache_init(2, 16),
                                 tt.encode(model, frames))
    steps = []
    for t in range(16):
        lg, cache = bundle.decode(model, tokens[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, dim=1), full, **MODEL_TOL)


def test_engine_refuses_enc_dec():
    """The engine takes no frames, so it would decode against the zeroed
    cross cache of ``init_cache``, as the reference's does: refused."""
    _, tc, _, model = _whisper()
    with pytest.raises(NotImplementedError, match="prime_cross_cache"):
        ServeEngine(registry.build(tc, device="cpu"), model, max_batch=2,
                    max_seq=16)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["whisper-medium", "llava-next-34b",
                                  "qwen3-8b"])
def test_input_specs_and_make_batch_equal_reference(name, kind):
    """The specs' keys, order, shapes and dtypes are the reference's, and
    ``make_batch`` on the CPU equals the reference's batch bitwise (bf16
    frames and embeds at the full configs' dtype, cut to a small shape)."""
    jc, tc = (dataclasses.replace(c, n_frontend_tokens=min(
        c.n_frontend_tokens, 8)) for c in (jax_get_arch(name),
                                           get_arch(name)))
    seq = 32 if kind != "decode" else 64
    specs = registry.input_specs(tc, ShapeConfig("t", seq, 2, kind))
    jspecs = jreg.input_specs(jc, JaxShape("t", seq, 2, kind))
    assert list(specs) == list(jspecs)
    got = registry.make_batch(tc, ShapeConfig("t", seq, 2, kind), seed=7,
                              device="cpu")
    want = jreg.make_batch(jc, JaxShape("t", seq, 2, kind), seed=7)
    for key, spec in specs.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == jspecs[key].shape
        assert str(spec.dtype).split(".")[-1] == str(jspecs[key].dtype)
        assert got[key].dtype == spec.dtype and got[key].shape == spec.shape
        assert np.array_equal(got[key].float().numpy(),
                              np.asarray(want[key], np.float32))
