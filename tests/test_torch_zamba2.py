"""The port's hybrid family (``repro_torch.models.zamba2``, the
``"hybrid"`` bundle, the engine and the launcher on it) against the JAX
package's on the CPU.

The config is the reduced ``zamba2-7b`` with a vocabulary of 97; the JAX
parameters (``PRNGKey(0)``) cross by ``interop.params_from_jax``. The JAX
shared block's attention runs through its CPU path, the chunked plain
version, as in ``tests/test_torch_lm.py``.

The reference engine steps every slot's SSM state with the full-batch
step and never resets a slot's state at admission (ROADMAP Queue 3), so
its completions are a yardstick only for the first request at
``max_batch`` 1; the port's engine is held to the greedy forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import registry as jreg
from repro.models import zamba2 as jz
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import registry
from repro_torch.models import zamba2 as tz
from repro_torch.serve.engine import Request, ServeEngine

#: Logits after the whole reduced model, f32 (tests/test_torch_lm.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: Decode against prefill of the same model (tests/test_archs.py).
CONSISTENCY_TOL = dict(rtol=5e-2, atol=5e-2)
#: The two prompts of the reference engine's state fault, 4 new tokens.
PROMPTS = ([5, 17, 31, 8], [9, 3, 44, 2])


@functools.lru_cache(maxsize=None)
def _setup(n_layers=4):
    """Both configs (``n_layers`` 4: two groups; 5: two groups and a
    tail layer), the JAX params and the port's model holding them."""
    jc = dataclasses.replace(jax_get_arch("zamba2-7b").reduced(), vocab=97,
                             n_layers=n_layers)
    tc = dataclasses.replace(get_arch("zamba2-7b").reduced(), vocab=97,
                             n_layers=n_layers)
    params = jax.jit(lambda k: jz.init_params(jc, k))(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, params_from_jax(tree, tc, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _tokens(seed, b, s, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_schedule_at_full_width():
    assert tz.schedule(get_arch("zamba2-7b")) == (13, 6, 3)


def test_params_cross_and_init_draws_the_reference_shapes():
    jc, tc, params, model = _setup()
    assert torch.equal(model.layers[1].in_proj, torch.from_numpy(
        np.array(params["mamba_layers"]["in_proj"][1])))
    assert torch.equal(model.shared.attn.wq, torch.from_numpy(
        np.array(params["shared_attn"]["attn"]["wq"])))
    fresh = tz.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in fresh.parameters()) == tc.num_params()
    assert abs(float(fresh.embed.std()) - 0.02) < 3e-3


@pytest.mark.parametrize("n_layers", [4, 5])
def test_forward_logits(n_layers):
    jc, tc, params, model = _setup(n_layers)
    tokens = _tokens(0, 2, 32)
    got = tz.forward(model, torch.from_numpy(tokens).long())
    want = jax.jit(jz.forward, static_argnums=1)(params, jc,
                                                 jnp.asarray(tokens))
    assert got.shape == (2, 32, tc.vocab)
    _close(got, want, MODEL_TOL)


def test_prefill_step_through_the_bundle():
    jc, tc, params, model = _setup()
    tokens = _tokens(1, 3, 16)
    got = registry.build(tc, device="cpu").make_prefill_step()(
        model, {"tokens": torch.from_numpy(tokens).long()})
    want = jax.jit(jreg.build(jc).make_prefill_step())(
        params, {"tokens": jnp.asarray(tokens)})
    _close(got, want, MODEL_TOL)


def test_decode_step_with_cache():
    """12 positions of ``decode_step`` (every row written, the reference's
    step) with a tail layer: logits and every cache tensor equal JAX's."""
    jc, tc, params, model = _setup(5)
    tokens = _tokens(2, 2, 12)
    cache = tz.init_cache(tc, 2, 12, "cpu")
    jcache = jz.init_cache(jc, 2, 12)
    step = jax.jit(lambda p, t, c, pos: jz.decode_step(p, jc, t, c, pos))
    for pos in range(12):
        tok = tokens[:, pos:pos + 1]
        lg, cache = tz.decode_step(model, torch.from_numpy(tok).long(),
                                   cache, pos)
        jlg, jcache = step(params, jnp.asarray(tok), jcache,
                           jnp.asarray(pos, jnp.int32))
        _close(lg, jlg, MODEL_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], MODEL_TOL)
    for key in ("h", "conv"):
        _close(cache["ssm"][key], jcache["ssm"][key], MODEL_TOL)


def test_decode_matches_prefill():
    _, tc, _, model = _setup(5)
    bundle = registry.build(tc, device="cpu")
    tokens = torch.from_numpy(_tokens(3, 2, 16)).long()
    full = bundle.forward(model, {"tokens": tokens})
    cache = bundle.cache_init(2, 16)
    steps = []
    for t in range(16):
        lg, cache = bundle.decode(model, tokens[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, full, **CONSISTENCY_TOL)


def _random_cache(tc, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    cache = tz.init_cache(tc, b, s, "cpu")
    for x in (cache["k"], cache["v"], *cache["ssm"].values()):
        x.copy_(torch.randn(x.shape, generator=g))
    return cache


def _flat(cache):
    return {"k": cache["k"], "v": cache["v"], **cache["ssm"]}


@pytest.mark.parametrize("pos", [0, 3])
def test_decode_rows_leave_the_other_rows_alone(pos):
    """``rows=[1]`` writes row 1's K/V, ``h`` and ``conv`` and leaves rows
    0 and 2 bitwise as they were; row 1 equals the all-rows step's. At
    position 0 the stepped row starts from a zero SSM state."""
    _, tc, _, model = _setup(5)
    tok = torch.tensor([[3], [4], [5]])
    before = _flat(_random_cache(tc, 3, 8, 0))
    lg_all, full = tz.decode_step(model, tok, _random_cache(tc, 3, 8, 0),
                                  pos)
    lg_row, part = tz.decode_step(model, tok, _random_cache(tc, 3, 8, 0),
                                  pos, rows=[1])
    assert torch.equal(lg_row[1], lg_all[1])
    for key, x in _flat(part).items():
        assert torch.equal(x[:, 1], _flat(full)[key][:, 1]), key
        assert torch.equal(x[:, [0, 2]], before[key][:, [0, 2]]), key
    if pos == 0:  # the reset: the same as a fresh cache for row 1
        fresh = tz.init_cache(tc, 3, 8, "cpu")
        lg0, _ = tz.decode_step(model, tok, fresh, 0, rows=[1])
        assert torch.equal(lg_row[1], lg0[1])


def _greedy(bundle, model, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        lg = bundle.forward(model, {"tokens": torch.tensor([seq])})
        seq.append(int(lg[0, -1].argmax()))
    return seq[len(prompt):]


@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_engine_equals_greedy_forward(max_batch):
    """The prompts of the reference's state fault, each admitted twice
    (rids 0–3), so that a slot is re-used by a later request (every slot
    at ``max_batch`` 1 and 2); at ``max_batch`` 2 and 3 slots tick at one
    position. Every completion equals the greedy forward token for
    token."""
    _, tc, _, model = _setup()
    bundle = registry.build(tc, device="cpu")
    want = [_greedy(bundle, model, p, 4) for p in PROMPTS]
    eng = ServeEngine(bundle, model, max_batch=max_batch, max_seq=16)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=list(PROMPTS[rid % 2]),
                           max_new_tokens=4))
    got = {c.rid: c.tokens for c in eng.run_until_drained()}
    assert got == {rid: want[rid % 2] for rid in range(4)}


def test_first_request_equals_the_jax_engine():
    """The one request the reference engine serves from a clean state:
    the first at ``max_batch`` 1."""
    jc, tc, params, model = _setup()
    jeng = JaxEngine(jreg.build(jc), params, max_batch=1, max_seq=16)
    eng = ServeEngine(registry.build(tc, device="cpu"), model, max_batch=1,
                      max_seq=16)
    for rid, p in enumerate(PROMPTS):
        jeng.submit(JaxRequest(rid=rid, prompt=list(p), max_new_tokens=4))
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=4))
    want = {c.rid: c.tokens for c in jeng.run_until_drained()}
    got = {c.rid: c.tokens for c in eng.run_until_drained()}
    assert got[0] == want[0]


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", "zamba2-7b", "--device", "cpu", "--requests",
                 "3", "--new-tokens", "3", "--max-batch", "2"])
    assert sorted(len(c.tokens) for c in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert "zamba2-7b (reduced: 0.7M)" in out
    assert "3 completions, 9 tokens" in out
