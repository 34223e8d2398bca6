"""The port's continuous-batching engine (``repro_torch.serve.engine``) on
the CPU, against the JAX engine and the teacher-forced greedy forward.

The config is ``tests/test_substrate.py``'s engine config; the JAX
parameters cross by ``interop.params_from_jax``. At ``max_batch`` 1 the
port's engine must give the JAX engine's tokens. With more slots the port
writes K/V only into the slots a step advances, and every completion must
equal the greedy argmax of the teacher-forced forward, of the port's and
of the reference's model; the JAX engine does not meet that contract with
two slots at one position (ROADMAP Queue 3), so it is not compared there.
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
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Request, ServeEngine

SMALL = dict(n_layers=2, d_model=64, vocab=97, n_heads=2, n_kv_heads=2,
             head_dim=32)


@functools.lru_cache(maxsize=None)
def _setup():
    jc = dataclasses.replace(jax_get_arch("qwen3-8b").reduced(), **SMALL)
    tc = dataclasses.replace(get_arch("qwen3-8b").reduced(), **SMALL)
    jb = jreg.build(jc)
    params = jb.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    bundle = registry.build(tc, device="cpu")
    return jb, params, bundle, params_from_jax(tree, tc, "cpu")


def _greedy_ok(tokens, prompt, logits_of):
    seq = list(prompt)
    for t in tokens:
        if t != int(np.argmax(logits_of(seq))):
            return False
        seq.append(t)
    return True


def _port_logits(bundle, model):
    return lambda seq: bundle.forward(
        model, {"tokens": torch.tensor([seq])})[0, -1].numpy()


def _jax_logits(jb, params):
    fwd = jax.jit(jb.forward)
    return lambda seq: np.asarray(
        fwd(params, {"tokens": jnp.asarray([seq], jnp.int32)})[0, -1])


def test_single_slot_equals_the_jax_engine():
    jb, params, bundle, model = _setup()
    prompts = [[5, 17, 31], [7, 2, 44, 9]]
    jeng = JaxEngine(jb, params, max_batch=1, max_seq=32)
    eng = ServeEngine(bundle, model, max_batch=1, max_seq=32)
    for rid, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=rid, prompt=list(p), max_new_tokens=5))
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=5))
    want = {c.rid: c.tokens for c in jeng.run_until_drained()}
    got = {c.rid: c.tokens for c in eng.run_until_drained()}
    assert got == want


@pytest.mark.parametrize("max_batch", [2, 3])
def test_batched_engine_equals_greedy_forward(max_batch):
    """Five requests (tests/test_substrate.py's batched setup): slots
    admitted together replay in lockstep and tick at one position."""
    jb, params, bundle, model = _setup()
    eng = ServeEngine(bundle, model, max_batch=max_batch, max_seq=64)
    prompts = {rid: [1 + rid, 2, 3] for rid in range(5)}
    for rid, p in prompts.items():
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=4))
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == [0, 1, 2, 3, 4]
    port, ref = _port_logits(bundle, model), _jax_logits(jb, params)
    for c in done:
        assert len(c.tokens) == 4
        assert _greedy_ok(c.tokens, prompts[c.rid], port)
        assert _greedy_ok(c.tokens, prompts[c.rid], ref)


def test_two_slots_at_one_position_keep_their_cache_rows():
    """The reproduction of the reference engine's multi-slot fault: two
    requests, six new tokens, ``max_batch`` 2. Each completion is the
    teacher-forced greedy continuation."""
    jb, params, bundle, model = _setup()
    prompts = [[5, 17, 31], [7, 2, 44]]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=32)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=6))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    ref = _jax_logits(jb, params)
    for rid, p in enumerate(prompts):
        assert _greedy_ok(done[rid], p, ref), (rid, done[rid])
    # one full-batch step per lockstep replay position and per slot-tick
    assert eng.decode_calls == 2 + 2 * 6


def test_decode_rows():
    """``rows=None`` is the reference's step (tests/test_torch_lm.py holds
    it to JAX's); ``rows`` writes only the listed batch rows."""
    _, _, bundle, model = _setup()
    cfg = bundle.cfg
    tok = torch.tensor([[3], [4], [5]])
    full = bundle.cache_init(3, 8)
    lg_all, _ = tt.decode_step(model, tok, full, 2)
    part = bundle.cache_init(3, 8)
    lg_rows, _ = tt.decode_step(model, tok, part, 2, rows=[1])
    assert torch.equal(lg_rows[1], lg_all[1])
    for key in ("k", "v"):
        assert torch.equal(part[key][:, 1], full[key][:, 1])
        assert not part[key][:, [0, 2]].any()
        assert full[key][:, :, :, 2].abs().sum() > 0
    assert part["k"].shape == (cfg.n_layers, 3, cfg.n_kv_heads, 8,
                               cfg.head_dim)


def test_run_until_drained_raises_instead_of_truncating():
    _, _, bundle, model = _setup()
    eng = ServeEngine(bundle, model, max_batch=1, max_seq=64)
    eng.submit(Request(rid=3, prompt=[1, 2, 3], max_new_tokens=40))
    eng.submit(Request(rid=4, prompt=[4, 5], max_new_tokens=40))
    with pytest.raises(RuntimeError, match=r"undrained.*3"):
        eng.run_until_drained(max_ticks=2)


def test_temperature_sampling_is_seeded():
    _, _, bundle, model = _setup()

    def run(seed):
        eng = ServeEngine(bundle, model, max_batch=2, max_seq=32, seed=seed)
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=[rid + 1, 9], temperature=1.5,
                               max_new_tokens=6))
        return {c.rid: c.tokens for c in eng.run_until_drained()}

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < 97 for toks in a.values() for t in toks)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", "qwen3-8b", "--device", "cpu", "--requests", "3",
                 "--new-tokens", "3", "--max-batch", "2"])
    assert sorted(len(c.tokens) for c in done) == [3, 3, 3]
    assert "3 completions, 9 tokens" in capsys.readouterr().out
