"""The port's SSM family (``repro_torch.models.xlstm``, the ``"ssm"``
bundle, the engine and the launcher on it) against the JAX package's on
the CPU.

The config is the reduced ``xlstm-125m`` (d 128, 4 heads: mLSTM head dim
64, sLSTM head dim 32, chunk 16) with three blocks, mLSTM, sLSTM, mLSTM,
and a vocabulary of 97; the JAX parameters (``PRNGKey(0)``) cross by
``interop.params_from_jax``. Every comparison is f32 at the tolerance
named beside it.

The reference engine steps every slot's recurrent state with the
full-batch step (ROADMAP Queue 3), so the port's engine is held to the
greedy forward.
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
from repro.models import xlstm as jx
from repro_torch.configs import get_arch
from repro_torch.interop import param_tree, params_from_jax
from repro_torch.models import registry
from repro_torch.models import xlstm as tx
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.checkpoint import tree_flatten

#: One block or the whole reduced model, f32 (tests/test_torch_lm.py).
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: The chunked cell alone, f32: the same sums in another order.
CELL_TOL = dict(rtol=1e-5, atol=1e-5)
#: Decode against the chunked forward (tests/test_models.py:80).
CONSISTENCY_TOL = dict(rtol=2e-3, atol=2e-4)
PATTERN = ("mlstm", "slstm")
PROMPTS = ([5, 17, 31, 8], [9, 3, 44, 2])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are small: one intra-op thread each, so that the
    tier-1 run's six xdist workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**changes):
    changes = dict(n_layers=3, block_pattern=PATTERN, vocab=97, **changes)
    return (dataclasses.replace(jax_get_arch("xlstm-125m").reduced(),
                                **changes),
            dataclasses.replace(get_arch("xlstm-125m").reduced(), **changes))


@functools.lru_cache(maxsize=None)
def _setup():
    jc, tc = _cfgs()
    params = jax.jit(lambda k: jreg.xlstm_init(jc, k))(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, params_from_jax(tree, tc, "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(seed, b, s, vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t(x):
    """A tensor of its own copy of ``x``: the decode steps write their
    state in place, and a JAX array made from the same numpy buffer may
    share its memory (``jnp.asarray`` aliases an aligned buffer on the
    CPU)."""
    return torch.from_numpy(np.array(x))


def test_pattern_and_num_params():
    """The default pattern puts an sLSTM at every 6th block; the count
    walks the real module and equals the reference's ``eval_shape``
    count, at full size and reduced."""
    full = get_arch("xlstm-125m")
    assert registry._xlstm_pattern(full) == jreg._xlstm_pattern(
        jax_get_arch("xlstm-125m"))
    assert [i for i, k in enumerate(registry._xlstm_pattern(full))
            if k == "slstm"] == [5, 11]
    for name in ("xlstm-125m",):
        assert get_arch(name).num_params() == jax_get_arch(
            name).num_params() == 190_738_176
        assert (get_arch(name).reduced().num_params()
                == jax_get_arch(name).reduced().num_params())
    jc, tc = _cfgs()
    fresh = registry.xlstm_init(tc, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in fresh.parameters()) == jc.num_params()
    assert abs(float(fresh.embed.std()) - 0.02) < 3e-3


def test_param_tree_is_the_reference_tree():
    """Same keys, order and shapes as the reference's init tree, each leaf
    the module's own tensor."""
    jc, tc, params, model = _setup()
    tree = param_tree(model)
    jleaves, jdef = jax.tree_util.tree_flatten(params)
    leaves, _ = tree_flatten(tree)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jleaves]
    assert tree["blocks"][1]["r_zifo"] is model.blocks[1].r_zifo
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(
        lambda x: 0, tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    ) == jdef


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked(chunk, with_state):
    """The chunked cell at two chunk sizes, from the initial state (``m``
    at ``-inf``) and from a carried one: ``h`` and the chunk-end state."""
    b, s, h, d = 2, 32, 3, 8
    q, k, v = (_normal(i, (b, s, h, d)) for i in range(3))
    i_raw, f_raw = _normal(3, (b, s, h)), _normal(4, (b, s, h), 2.0)
    state = None
    if with_state:
        state = {"C": _normal(5, (b, h, d, d)), "n": _normal(6, (b, h, d)),
                 "m": _normal(7, (b, h))}
    want_h, want_st = jax.jit(jx._mlstm_chunked, static_argnums=5)(
        q, k, v, i_raw, f_raw, chunk, state)
    got_h, got_st = tx._mlstm_chunked(
        *map(_t, (q, k, v, i_raw, f_raw)), chunk,
        None if state is None else {n: _t(x) for n, x in state.items()})
    _close(got_h, want_h, CELL_TOL)
    for name in ("C", "n", "m"):
        _close(got_st[name], want_st[name], CELL_TOL)


def test_mlstm_chunked_raises_on_a_ragged_sequence():
    x = torch.zeros((1, 24, 1, 4))
    g = torch.zeros((1, 24, 1))
    with pytest.raises(ValueError, match="must tile"):
        tx._mlstm_chunked(x, x, x, g, g, 16)


def test_block_apply_and_decode():
    """``mlstm_block_apply`` and ``slstm_block_apply`` on a sequence, then
    four steps of each decode from their returned states, against the
    reference with every state tensor."""
    jc, tc, params, model = _setup()
    x = _normal(8, (2, 32, tc.d_model))
    steps = _normal(9, (4, 2, 1, tc.d_model))
    for i, kind in enumerate(PATTERN):
        jp, tp = params["blocks"][i], model.blocks[i]
        japply = jx.mlstm_block_apply if kind == "mlstm" else \
            jx.slstm_block_apply
        jdec = jx.mlstm_block_decode if kind == "mlstm" else \
            jx.slstm_block_decode
        tapply = tx.mlstm_block_apply if kind == "mlstm" else \
            tx.slstm_block_apply
        tdec = tx.mlstm_block_decode if kind == "mlstm" else \
            tx.slstm_block_decode
        want, jst = jax.jit(lambda p, y: japply(p, y, jc, return_state=True))(
            jp, x)
        got, st = tapply(tp, _t(x), tc, return_state=True)
        _close(got, want, MODEL_TOL)
        if kind == "mlstm":  # the decode state adds the conv history
            conv = _normal(10, (2, 3, 2 * tc.d_model))
            jst, st = dict(jst, conv=jnp.asarray(conv)), dict(st,
                                                              conv=_t(conv))
        step = jax.jit(lambda p, y, s: jdec(p, y, jc, s))
        for y in steps:
            want, jst = step(jp, y, jst)
            got, st = tdec(tp, _t(y), tc, st)
            _close(got, want, MODEL_TOL)
        for name, value in st.items():
            _close(value, jst[name], MODEL_TOL)


def test_forward_logits():
    jc, tc, params, model = _setup()
    tokens = _tokens(0, 2, 32)
    got = registry.xlstm_forward(model, _t(tokens))
    want = jax.jit(jreg.xlstm_forward, static_argnums=1)(params, jc,
                                                         jnp.asarray(tokens))
    assert got.shape == (2, 32, tc.vocab)
    _close(got, want, MODEL_TOL)


def test_prefill_step_through_the_bundle():
    jc, tc, params, model = _setup()
    tokens = _tokens(1, 3, 16)
    got = registry.build(tc, device="cpu").make_prefill_step()(
        model, {"tokens": _t(tokens)})
    want = jax.jit(jreg.build(jc).make_prefill_step())(
        params, {"tokens": jnp.asarray(tokens)})
    _close(got, want, MODEL_TOL)


def test_decode_with_cache_and_against_the_forward():
    """12 steps of ``xlstm_decode`` (every row written, the reference's
    step): logits and every block's state equal JAX's, and the decode
    logits equal the chunked forward's."""
    jc, tc, params, model = _setup()
    tokens = _tokens(2, 2, 12)
    cache = registry.xlstm_cache_init(tc, 2, 12, "cpu")
    jcache = jreg.xlstm_cache_init(jc, 2, 12)
    step = jax.jit(lambda p, t, c: jreg.xlstm_decode(p, jc, t, c, 0))
    rows = []
    for pos in range(12):
        tok = tokens[:, pos:pos + 1]
        lg, cache = registry.xlstm_decode(model, _t(tok), cache, pos)
        jlg, jcache = step(params, jnp.asarray(tok), jcache)
        _close(lg, jlg, MODEL_TOL)
        rows.append(lg[:, 0])
    for st, jst in zip(cache, jcache):
        for name, value in st.items():
            _close(value, jst[name], MODEL_TOL)
    full = registry.xlstm_forward(model, _t(tokens))
    torch.testing.assert_close(torch.stack(rows, dim=1), full,
                               **CONSISTENCY_TOL)


def _random_cache(tc, b, seed):
    g = torch.Generator().manual_seed(seed)
    cache = registry.xlstm_cache_init(tc, b, 8, "cpu")
    for st in cache:
        for x in st.values():
            x.copy_(torch.randn(x.shape, generator=g))
    return cache


@pytest.mark.parametrize("pos", [0, 3])
def test_decode_rows_leave_the_other_rows_alone(pos):
    """``rows=[1]`` writes row 1's state in every block and leaves rows 0
    and 2 bitwise as they were; row 1 equals the all-rows step's. At
    position 0 the stepped row starts from the state-init values (mLSTM
    ``m`` -inf, sLSTM ``n`` one), the same as a fresh cache."""
    _, tc, _, model = _setup()
    tok = torch.tensor([[3], [4], [5]])
    before = _random_cache(tc, 3, 0)
    lg_all, full = registry.xlstm_decode(model, tok, _random_cache(tc, 3, 0),
                                         pos)
    lg_row, part = registry.xlstm_decode(model, tok, _random_cache(tc, 3, 0),
                                         pos, rows=[1])
    assert torch.equal(lg_row[1], lg_all[1])
    for st, st_full, st0 in zip(part, full, before):
        for name, x in st.items():
            assert torch.equal(x[1], st_full[name][1]), name
            assert torch.equal(x[[0, 2]], st0[name][[0, 2]]), name
    if pos == 0:
        fresh = registry.xlstm_cache_init(tc, 3, 8, "cpu")
        lg0, _ = registry.xlstm_decode(model, tok, fresh, 0, rows=[1])
        assert torch.equal(lg_row[1], lg0[1])


@functools.lru_cache(maxsize=None)
def _greedy(prompt, n=4):
    """The greedy forward's ``n`` tokens after ``prompt`` (a tuple)."""
    _, tc, _, model = _setup()
    bundle = registry.build(tc, device="cpu")
    seq = list(prompt)
    for _ in range(n):
        lg = bundle.forward(model, {"tokens": torch.tensor([seq])})
        seq.append(int(lg[0, -1].argmax()))
    return seq[len(prompt):]


@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_engine_equals_greedy_forward(max_batch):
    """Each prompt admitted twice (rids 0–3), so that a slot is re-used by
    a later request; at ``max_batch`` 2 and 3 slots tick at one position.
    Every completion equals the greedy forward token for token."""
    _, tc, _, model = _setup()
    bundle = registry.build(tc, device="cpu")
    want = [_greedy(tuple(p)) for p in PROMPTS]
    eng = ServeEngine(bundle, model, max_batch=max_batch, max_seq=16)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=list(PROMPTS[rid % 2]),
                           max_new_tokens=4))
    got = {c.rid: c.tokens for c in eng.run_until_drained()}
    assert got == {rid: want[rid % 2] for rid in range(4)}


def test_gradient_through_the_first_chunk_is_finite():
    """The loss's gradient, one chunk and two, from the initial state
    (``m`` at -inf): every parameter's gradient finite and the embedding's
    nonzero; the cell's inputs get finite gradients from a state of
    ``-inf`` too."""
    _, tc, _, model = _setup()
    bundle = registry.build(tc, device="cpu")
    for s in (16, 32):
        tokens = _t(_tokens(4, 2, s))
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
        loss = bundle.loss(model, {"tokens": tokens, "labels": tokens})
        grads = torch.autograd.grad(loss, params)
        for p in params:
            p.requires_grad_(False)
        assert all(torch.isfinite(g).all() for g in grads)
        assert float(grads[0].abs().max()) > 0
    q, k, v = (_t(_normal(i, (1, 16, 2, 4))).requires_grad_(True)
               for i in range(3))
    g = _t(_normal(3, (1, 16, 2))).requires_grad_(True)
    h, st = tx._mlstm_chunked(q, k, v, g, g, 8)
    grads = torch.autograd.grad(h.sum() + st["C"].sum(), (q, k, v, g))
    assert all(torch.isfinite(x).all() for x in grads)


def test_serving_records_no_graph():
    """The serving entry points record no graph even on trainable
    parameters."""
    _, tc, _, model = _setup()
    tokens = torch.tensor([[1, 2, 3]])
    for p in model.parameters():
        p.requires_grad_(True)
    try:
        assert not registry.xlstm_forward(model, tokens).requires_grad
        cache = registry.xlstm_cache_init(tc, 1, 4, "cpu")
        lg, cache = registry.xlstm_decode(model, tokens[:, :1], cache, 0)
        assert not lg.requires_grad
        assert not any(x.requires_grad for st in cache for x in st.values())
    finally:
        for p in model.parameters():
            p.requires_grad_(False)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    done = main(["--arch", "xlstm-125m", "--device", "cpu", "--requests",
                 "3", "--new-tokens", "3", "--max-batch", "2"])
    assert sorted(len(c.tokens) for c in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert "xlstm-125m (reduced: 0.7M)" in out
    assert "3 completions, 9 tokens" in out
