"""The port's training path (``repro_torch.train.optimizer``, ``data``,
``loop``, the bundles' ``loss`` and ``make_train_step``, the launcher and
the example) against the JAX package's on the CPU, and flash attention's
``FlashAttentionFn`` on the CPU's plain path.

Models are the reduced configs (f32), the JAX parameters (``PRNGKey(0)``)
carried across by ``interop.params_from_jax``; batches are the seeded
numpy batches both packages draw alike. Every comparison states its f32
tolerance. The loop and checkpoint tests mirror
``tests/test_substrate.py``'s, on its tiny xLSTM.
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
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.interop import (
    Stacked,
    leaf_parts,
    param_tree,
    params_from_jax,
)
from repro_torch.kernels import build
from repro_torch.kernels.adamw import adamw
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn,
    attention,
    attention_chunked_ref,
)
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as tdata
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

#: One optimizer update, f32 on both sides.
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
#: Loss of a reduced model, f32 (tests/test_torch_lm.py's logits rtol).
LOSS_TOL = dict(rel=1e-5, abs=1e-5)
#: A gradient leaf of a reduced model, f32: rtol 1e-3, and an atol of
#: 1e-4 of the leaf's largest magnitude (sums of many products in
#: another order).
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4
#: Parameters and moments after one AdamW step (lr 5e-4). The first
#: update is g / (|g| + eps), whose slope near g = 0 is 1 / eps: at the
#: default eps 1e-8 an f32 gradient difference of 1e-10 (a rounding-level
#: one) flips such an element's update by up to 1e-2 lr, so the step test
#: runs at eps 1e-4, where the update reads the gradient, not its
#: rounding: the wiring (microbatch split, f32 sums, metrics) is what it
#: tests.
STEP_TOL = dict(rtol=1e-5, atol=2e-6)
FAMILIES = {"dense": "qwen3-8b", "moe": "mixtral-8x7b",
            "vlm": "llava-next-34b", "audio": "whisper-medium",
            "hybrid": "zamba2-7b", "ssm": "xlstm-125m"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are small: one intra-op thread each, so that the
    tier-1 run's six xdist workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    x = x.stack() if isinstance(x, Stacked) else x
    return x.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# ----------------------------- optimizer -----------------------------


def test_adamw_matches_reference_math():
    cfg = topt.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8,
                           weight_decay=0.0, clip_norm=1e9, warmup_steps=1,
                           total_steps=10**9)
    params = {"w": torch.tensor([[1.0, -2.0]])}
    state = topt.init_state(cfg, params)
    p1, s1, _ = topt.apply_updates(cfg, params,
                                   {"w": torch.tensor([[0.5, 0.25]])}, state)
    g = np.asarray([[0.5, 0.25]])
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.01 * g * g / (1 - 0.99)
    lr = float(topt.lr_at(cfg, s1["step"] - 1))
    want = np.asarray([[1.0, -2.0]]) - lr * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(), want, rtol=1e-5)
    assert p1["w"] is params["w"]  # in place
    assert s1["step"].dtype == torch.int32 and int(s1["step"]) == 1


def test_adamw_clipping_and_decay():
    cfg = topt.AdamWConfig(lr=1e-2, clip_norm=0.1, weight_decay=0.5,
                           warmup_steps=1, total_steps=10**9)
    params = {"w": torch.ones((4, 4))}
    state = topt.init_state(cfg, params)
    _, _, metrics = topt.apply_updates(
        cfg, params, {"w": torch.ones((4, 4)) * 100.0}, state)
    assert float(metrics["grad_norm"]) == pytest.approx(400.0, rel=1e-4)


def test_adamw_bf16_states():
    cfg = topt.AdamWConfig(state_dtype="bfloat16")
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = topt.init_state(cfg, params)
    assert state["m"]["w"].dtype == torch.bfloat16
    p1, s1, _ = topt.apply_updates(
        cfg, params, {"w": torch.ones(8, dtype=torch.bfloat16)}, state)
    assert s1["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(p1["w"].float()).all())


def test_lr_schedule_equals_the_reference():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    lrs = [float(topt.lr_at(cfg, s)) for s in range(100)]
    assert lrs[0] < lrs[9]  # warmup
    assert max(lrs) == pytest.approx(1.0, rel=0.01)
    assert lrs[-1] == pytest.approx(0.1, rel=0.1)  # cosine floor
    np.testing.assert_allclose(
        lrs, [float(jopt.lr_at(jcfg, s)) for s in range(100)], rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_equals_the_reference(state_dtype):
    """Three steps on a tree of a matrix, a vector, a stacked leaf (a
    per-layer vector, decayed as the stacked matrix it is in the
    reference) and bf16 parameters, clipped: parameters, moments, step
    and metrics."""
    kw = dict(lr=1e-2, clip_norm=0.5, weight_decay=0.3, warmup_steps=2,
              total_steps=10, state_dtype=state_dtype)
    cfg, jcfg = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,), "s": (2, 5), "h": (3, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    dtypes = {"w": jnp.float32, "b": jnp.float32, "s": jnp.float32,
              "h": jnp.bfloat16}
    jparams = {k: jnp.asarray(v, dtypes[k]) for k, v in init.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tparams["h"] = tparams["h"].to(torch.bfloat16)
    tparams["s"] = Stacked([torch.from_numpy(init["s"][i].copy())
                            for i in range(2)])
    jstate, tstate = jopt.init_state(jcfg, jparams), topt.init_state(
        cfg, tparams)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in shapes.items()}
        jparams, jstate, jm = jax.jit(
            lambda p, gr, s: jopt.apply_updates(jcfg, p, gr, s))(
            jparams, {k: jnp.asarray(v, dtypes[k]) for k, v in g.items()},
            jstate)
        tg = {k: torch.from_numpy(v).to(tparams[k].dtype)
              for k, v in g.items() if k != "s"}
        tg["s"] = Stacked([torch.from_numpy(g["s"][i]) for i in range(2)])
        tparams, tstate, tm = topt.apply_updates(cfg, tparams, tg, tstate)
        for k in shapes:
            tol = OPT_TOL if dtypes[k] == jnp.float32 else dict(
                rtol=1e-2, atol=1e-2)
            _close(tparams[k], jparams[k], tol)
            for mom in ("m", "v"):
                assert tstate[mom][k].dtype == getattr(torch, state_dtype)
                _close(tstate[mom][k], jstate[mom][k], OPT_TOL)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-6)


def _small_tree(device, dtype=torch.float32):
    """A matrix, a vector and a stacked leaf of three layers, with
    gradients and a fresh optimizer state."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

    params = {"w": rand(3, 4), "b": rand(4),
              "layers": {"s": Stacked([rand(2, 5) for _ in range(3)])}}
    grads = {"w": rand(3, 4), "b": rand(4),
             "layers": {"s": Stacked([rand(2, 5) for _ in range(3)])}}
    return params, grads, topt.init_state(topt.AdamWConfig(), params)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_apply_updates_off_the_card_runs_the_plain_version(device):
    """A CPU or ``meta`` tree takes ``_global_norm`` and ``_update``: the
    kernels' launch counts stay as they were."""
    before = (adamw.adamw_sumsq.launches, adamw.adamw_step.launches)
    params, grads, state = _small_tree(device)
    _, state, metrics = topt.apply_updates(topt.AdamWConfig(), params,
                                           grads, state)
    assert metrics["grad_norm"].device.type == device
    assert state["m"]["layers"]["s"].shape == (3, 2, 5)
    assert (adamw.adamw_sumsq.launches, adamw.adamw_step.launches) == before


def test_parts_name_every_layer_and_decay_by_the_leaf():
    params, grads, state = _small_tree("cpu")
    parts = topt._parts(params, grads, state)
    assert [(p.name, p.decay) for p in parts] == [
        ("b", False), ("layers.s[0]", True), ("layers.s[1]", True),
        ("layers.s[2]", True), ("w", True)]
    assert parts[2].p is params["layers"]["s"].parts[1]
    assert parts[2].m.data_ptr() == state["m"]["layers"]["s"][1].data_ptr()


@pytest.mark.parametrize("name, ndim, want", [
    ("embed", 2, True), ("ln_f", 1, False), ("moe_layers.ln1", 2, True),
    ("moe_layers.moe.router", 3, True),
    ("moe_layers.moe.select_bias", 2, False), ("select_bias", 1, False),
])
def test_weight_decay_takes_matrices_but_not_the_selection_bias(name, ndim,
                                                                 want):
    """Decoupled weight decay on leaves of two or more dimensions (a
    stacked norm is one), never on the selection bias of sigmoid routing,
    which nothing trains."""
    assert topt.decays(name, ndim) is want


def _part(name, n, p=torch.float32, g=torch.float32, s=torch.float32,
          decay=True, offset=0):
    def x(dt):
        return torch.zeros(n + offset, dtype=dt)[offset:]

    return adamw.AdamWPart(name, x(p), x(g), x(s), x(s), decay)


def _entries(table):
    return [table.part[i] for i in range(table.n)]


def test_pack_chunks_tables_and_numbers_tiles():
    """More parts than a table holds: full tables in order, each part's
    tiles counted from its table's start; an empty part left out."""
    n = 2 * adamw.MAX_PARTS + 3
    sizes = [1 + 1000 * i for i in range(n)]
    parts = [_part(f"p{i}", k) for i, k in enumerate(sizes)]
    parts.insert(5, _part("empty", 0))
    tables = adamw.pack(parts)
    assert [t.n for t in tables] == [adamw.MAX_PARTS, adamw.MAX_PARTS, 3]
    flat = [e for t in tables for e in _entries(t)]
    assert [e.numel for e in flat] == sizes
    assert [e.p for e in flat] == [
        p.p.data_ptr() for p in parts if p.name != "empty"]
    for table in tables:
        entries = _entries(table)
        assert entries[0].tile0 == 0
        assert table.tiles == entries[-1].tile_end
        for a, b in zip(entries, entries[1:]):
            assert b.tile0 == a.tile_end
        for e in entries:
            assert e.tile_end - e.tile0 == -(-e.numel // adamw.TILE)
    (big,) = adamw.pack([_part("big", 3 * adamw.TILE + 5)])
    assert (big.part[0].tile0, big.part[0].tile_end, big.tiles) == (0, 4, 4)


@pytest.mark.parametrize("p,g,s,decay", [
    (torch.float32, torch.float32, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.float32, torch.bfloat16, False),
    (torch.float32, torch.bfloat16, torch.bfloat16, False),
])
def test_pack_dtype_codes_and_alignment(p, g, s, decay):
    (table,) = adamw.pack([_part("x", 64, p, g, s, decay)])
    codes = table.part[0].codes
    bf16 = torch.bfloat16
    want = ((adamw.P_BF16 if p == bf16 else 0)
            | (adamw.G_BF16 if g == bf16 else 0)
            | (adamw.S_BF16 if s == bf16 else 0)
            | (adamw.DECAY if decay else 0))
    assert codes & ~adamw.ALIGNED == want
    # a fresh tensor is 16-byte aligned; a view one element in is not
    assert codes & adamw.ALIGNED
    (table,) = adamw.pack([_part("x", 64, p, g, s, decay, offset=1)])
    assert not table.part[0].codes & adamw.ALIGNED


def test_pack_rejects_what_the_kernel_does_not_take_by_name():
    params, grads, state = _small_tree("cpu")
    params["layers"]["s"].parts[1] = params["layers"]["s"].parts[1].half()
    with pytest.raises(TypeError,
                       match=r"layers\.s\[1\]: p is torch\.float16"):
        adamw.pack(topt._parts(params, grads, state))
    params, grads, state = _small_tree("cpu")
    grads["w"] = grads["w"].t().contiguous().t()
    with pytest.raises(ValueError, match="w: g is not contiguous"):
        adamw.pack(topt._parts(params, grads, state))
    with pytest.raises(TypeError, match="one moment dtype"):
        adamw.pack([adamw.AdamWPart(
            "mv", *(torch.zeros(4) for _ in range(3)),
            torch.zeros(4, dtype=torch.bfloat16), True)])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_trains_through_the_kernel(arch, monkeypatch):
    """Each architecture's training step, on the CPU at reduced width and
    in the full config's parameter dtype, hands ``apply_updates`` parts the
    kernel takes: the real gradients of ``make_train_step`` (one batch, and
    two microbatches' f32 sums), with either moment dtype, packed as the
    card packs them. A gradient's layout is autograd's, so a transpose or
    einsum backward that left a view would fail here."""
    full = get_arch(arch)
    cfg = dataclasses.replace(full.reduced(), dtype=full.dtype)
    bundle = registry.build(cfg, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("t", 16, 2, "train"),
                                device="cpu")
    plain, packed = topt.apply_updates, []

    def packing(opt_cfg, params, grads, state):
        parts = topt._parts(params, grads, state)
        packed.append((sum(t.n for t in adamw.pack(parts)),
                       {p.g.dtype for p in parts}))
        return plain(opt_cfg, params, grads, state)

    monkeypatch.setattr(topt, "apply_updates", packing)
    for state_dtype in ("float32", "bfloat16"):
        opt_cfg = topt.AdamWConfig(state_dtype=state_dtype)
        for nm in (1, 2):
            state = topt.init_state(opt_cfg, param_tree(model))
            model, _, _ = bundle.make_train_step(opt_cfg, nm)(model, state,
                                                              batch)
    n = sum(len(leaf_parts(x))
            for x in ckpt.tree_flatten(param_tree(model))[0])
    assert [k for k, _ in packed] == [n] * 4
    assert getattr(torch, full.dtype) in packed[0][1]
    assert packed[1][1] == {torch.float32}


def test_adamw_library_keeps_fmad_off():
    """The kernel is held bitwise to ``_update``: no multiply-add may be
    contracted."""
    assert "-fmad=false" in build.flags_for("adamw")


# ----------------------------- data -----------------------------


def test_synthetic_tokens_bitwise_the_reference():
    for host in (0, 1):
        kw = dict(vocab=100, seq_len=8, global_batch=8, seed=1, num_hosts=2,
                  host_id=host)
        got = tdata.SyntheticTokens(tdata.DataConfig(**kw)).batch_at(5)
        want = jdata.SyntheticTokens(jdata.DataConfig(**kw)).batch_at(5)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    a = tdata.SyntheticTokens(tdata.DataConfig(100, 8, 8, 1, 2, 0)).batch_at(5)
    c = tdata.SyntheticTokens(tdata.DataConfig(100, 8, 8, 1, 2, 1)).batch_at(5)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_memmap_corpus_bitwise_the_reference(tmp_path):
    path = str(tmp_path / "corpus.bin")
    tdata.write_corpus(path, np.arange(10_000) % 251)
    other = str(tmp_path / "jax.bin")
    jdata.write_corpus(other, np.arange(10_000) % 251)
    assert open(path, "rb").read() == open(other, "rb").read()
    got = tdata.make_source(tdata.DataConfig(vocab=251, seq_len=16,
                                             global_batch=4, path=path))
    want = jdata.make_source(jdata.DataConfig(vocab=251, seq_len=16,
                                              global_batch=4, path=path))
    assert isinstance(got, tdata.MemmapTokens)
    for step in (0, 3):
        b1, b2 = got.batch_at(step), want.batch_at(step)
        assert b1["tokens"].shape == (4, 16)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b1[k], b2[k])
    with pytest.raises(ValueError, match="requires cfg.path"):
        tdata.MemmapTokens(tdata.DataConfig(vocab=2, seq_len=2,
                                            global_batch=1))


def test_prefetcher_orders_batches_as_the_source():
    cfg = tdata.DataConfig(vocab=50, seq_len=4, global_batch=2, seed=3)
    pf = tdata.Prefetcher(tdata.SyntheticTokens(cfg), start_step=7)
    want = jdata.SyntheticTokens(jdata.DataConfig(50, 4, 2, 3))
    try:
        for step in (7, 8, 9):
            s, batch = pf.next()
            assert s == step
            np.testing.assert_array_equal(batch["tokens"],
                                          want.batch_at(step)["tokens"])
    finally:
        pf.close()


# ----------------------------- losses and gradients ---------------------


@functools.lru_cache(maxsize=None)
def _family(fam):
    name = FAMILIES[fam]
    jc = jax_get_arch(name).reduced()
    tc = get_arch(name).reduced()
    if fam == "ssm":  # an sLSTM block beside the mLSTM ones
        jc, tc = (dataclasses.replace(c, n_layers=3,
                                      block_pattern=("mlstm", "slstm"))
                  for c in (jc, tc))
    jb = jreg.build(jc)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, jb, params, params_from_jax(tree, tc, "cpu")


def _grad_leaves(bundle, model, batch):
    """The loss and its gradient per leaf of the reference's tree (a
    stacked leaf's gradient stacked); grad turned off again after."""
    leaves, _ = ckpt.tree_flatten(param_tree(model))
    groups = [leaf.parts if isinstance(leaf, Stacked) else [leaf]
              for leaf in leaves]
    parts = [p for group in groups for p in group]
    for p in parts:
        p.requires_grad_(True)
    try:
        loss = bundle.loss(model, batch)
        grads = torch.autograd.grad(loss, parts, allow_unused=True)
    finally:
        for p in parts:
            p.requires_grad_(False)
    grads = iter(torch.zeros_like(p) if g is None else g
                 for p, g in zip(parts, grads))
    out = [torch.stack([next(grads) for _ in group])
           if isinstance(leaf, Stacked) else next(grads)
           for leaf, group in zip(leaves, groups)]
    return loss.detach(), out


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_loss_and_gradients_equal_jax(fam):
    """Every family's bundle ``loss`` and its gradient with respect to
    every leaf of the reference's tree against ``jax.value_and_grad`` of
    the reference's bundle loss, on the reference's train batch (a VLM's
    embeds, an audio model's frames)."""
    jc, tc, jb, params, model = _family(fam)
    batch = registry.make_batch(tc, ShapeConfig("t", 32, 2, "train"),
                                seed=1, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(jb.loss))(params, jbatch)
    loss, grads = _grad_leaves(registry.build(tc, device="cpu"), model,
                               batch)
    assert float(loss) == pytest.approx(float(want_loss), **LOSS_TOL)
    jleaves = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_FRAC * float(np.abs(w).max()) + 1e-12)


def test_vlm_loss_drops_the_embeds_positions():
    _, tc, _, _, model = _family("vlm")
    batch = registry.make_batch(tc, ShapeConfig("t", 32, 2, "train"),
                                seed=1, device="cpu")
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import cross_entropy

    logits = tfm.forward(model, batch["tokens"], batch["embeds"])
    want = cross_entropy(logits[:, tc.n_frontend_tokens:], batch["labels"])
    assert float(registry.build(tc, device="cpu").loss(model, batch)) == \
        pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("fam,num_microbatches", [
    pytest.param("dense", 1, id="1"), pytest.param("dense", 2, id="2"),
    *(pytest.param(fam, 1, id=f"{fam}-1")
      for fam in ("moe", "hybrid", "audio", "vlm"))])
def test_train_step_equals_jax(fam, num_microbatches):
    """One ``make_train_step`` (f32) against the reference's jitted step:
    the reduced dense model at 1 and 2 microbatches (f32 accumulation),
    and the MoE, hybrid, enc-dec and VLM families at one (the dispatch,
    the SSD and the shared block, the frames and the cross-attention, the
    embeds and the loss that drops their positions): parameters, both
    moments, step and the metrics."""
    jc, tc, jb, params, _ = _family(fam)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, tc, "cpu")
    kw = dict(lr=1e-3, eps=1e-4, warmup_steps=2, total_steps=100)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    batch = registry.make_batch(tc, ShapeConfig("t", 16, 4, "train"),
                                seed=2, device="cpu")
    jstep = jax.jit(jb.make_train_step(jcfg, num_microbatches))
    jparams, jstate, jm = jstep(params, jopt.init_state(jcfg, params),
                                {k: jnp.asarray(v.numpy())
                                 for k, v in batch.items()})
    bundle = registry.build(tc, device="cpu")
    state = topt.init_state(tcfg, param_tree(model))
    _, state, m = bundle.make_train_step(tcfg, num_microbatches)(
        model, state, {k: v.numpy() for k, v in batch.items()})
    got = ckpt.tree_flatten({"params": param_tree(model), "opt": state})[0]
    want = jax.tree_util.tree_leaves({"params": jparams, "opt": jstate})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, STEP_TOL)
    for name in ("loss", "grad_norm", "lr"):
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=2e-5)


def test_train_step_rejects_a_batch_the_microbatches_do_not_split():
    _, tc, _, _, model = _family("dense")
    cfg = topt.AdamWConfig()
    state = topt.init_state(cfg, param_tree(model))
    batch = registry.make_batch(tc, ShapeConfig("t", 8, 3, "train"),
                                device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        registry.build(tc, device="cpu").make_train_step(cfg, 2)(
            model, state, batch)


# ----------------------------- flash attention's gradient ---------------


def _qkv(seed, hq=4, hkv=2, s=64, d=16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((2, h, s, d), generator=g).requires_grad_(True)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("window", [0, 24])
def test_flash_function_gradient_equals_the_plain_path(window):
    """With an input that requires grad the dispatcher's kernel path runs
    ``FlashAttentionFn``; its gradient (the chunked version's, recomputed)
    equals autograd through the chunked version itself, and the CPU's
    default path (no kernel) differentiates as before."""
    q, k, v = _qkv(0)
    go = torch.randn((2, 4, 64, 16),
                     generator=torch.Generator().manual_seed(1))
    out = attention(q, k, v, window=window, use_kernel=True)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), go)
    ref = attention_chunked_ref(q, k, v, window=window, chunk=64)
    want = torch.autograd.grad(ref, (q, k, v), go)
    plain = torch.autograd.grad(attention(q, k, v, window=window), (q, k, v),
                                go)
    for a, b, c in zip(got, want, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c, b, rtol=1e-5, atol=1e-5)


def test_flash_function_only_with_grad():
    q, k, v = _qkv(2)
    with torch.no_grad():
        assert attention(q, k, v, use_kernel=True).grad_fn is None
    out = FlashAttentionFn.apply(q, k.detach(), v, True, 0, None, 64, 64)
    gq, gv = torch.autograd.grad(out.sum(), (q, v))
    assert gq.shape == q.shape and gv.shape == v.shape


# ----------------------------- loop + faults -----------------------------


TINY_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


@functools.lru_cache(maxsize=None)
def _tiny_reference():
    """The reference's ``_tiny_training`` pieces, built once: both
    configs, the JAX parameters and the jitted JAX step."""
    jc = dataclasses.replace(jax_get_arch("xlstm-125m").reduced(),
                             n_layers=2, d_model=64, vocab=64, n_heads=2,
                             n_kv_heads=2)
    tc = dataclasses.replace(get_arch("xlstm-125m").reduced(), n_layers=2,
                             d_model=64, vocab=64, n_heads=2, n_kv_heads=2)
    jb = jreg.build(jc)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jb.make_train_step(jopt.AdamWConfig(**TINY_OPT)))
    return tc, params, jstep


def _tiny(tmp_path, fail_at=(), steps=12):
    """The reference's ``_tiny_training`` xLSTM for both packages: the
    port's loop arguments and the reference's, with the same weights."""
    tc, params, jstep = _tiny_reference()
    tcfg = topt.AdamWConfig(**TINY_OPT)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc,
                            "cpu")
    loop_kw = dict(total_steps=steps, ckpt_dir=str(tmp_path / "ck"),
                   ckpt_every=4, log_every=100, fail_at_steps=fail_at)
    port = (tloop.LoopConfig(**loop_kw),
            tdata.DataConfig(vocab=64, seq_len=16, global_batch=2, seed=0),
            registry.build(tc, device="cpu").make_train_step(tcfg), model,
            topt.init_state(tcfg, param_tree(model)))
    ref = (jloop.LoopConfig(**loop_kw),
           jdata.DataConfig(vocab=64, seq_len=16, global_batch=2, seed=0),
           lambda p, o, b: jstep(p, o, {k: jnp.asarray(v)
                                        for k, v in b.items()}),
           params, jopt.init_state(jopt.AdamWConfig(**TINY_OPT), params))
    return port, ref


def test_loop_runs_clean(tmp_path):
    port, _ = _tiny(tmp_path)
    _, _, st = tloop.run_with_restarts(*port, log=lambda s: None)
    assert st.step == 12 and st.restarts == 0
    assert all(np.isfinite(st.losses))


def test_loop_restarts_after_fault_and_restores_bitwise(tmp_path):
    """Faults after steps 6 and 9: two restarts, step-complete, the newest
    checkpoint the final step, and every restore bitwise the tree that
    was saved."""
    port, _ = _tiny(tmp_path, fail_at=(6, 9))
    model, opt, st = tloop.run_with_restarts(*port, log=lambda s: None)
    assert st.restarts == 2 and st.step == 12
    ck = str(tmp_path / "ck")
    assert ckpt.available_steps(ck)[-1] == 12
    _, saved, _ = ckpt.restore_latest(ck, {"params": param_tree(model),
                                           "opt": opt})
    for a, b in zip(ckpt.tree_flatten(saved)[0], ckpt.tree_flatten(
            {"params": param_tree(model), "opt": opt})[0]):
        assert torch.equal(a, b.stack() if isinstance(b, Stacked) else b)


def test_loop_fault_resumes_data_stream(tmp_path):
    """A restarted run re-consumes the same step indices: the last loss
    equals the clean run's."""
    clean, _ = _tiny(tmp_path / "a")
    _, _, st1 = tloop.run_with_restarts(*clean, log=lambda s: None)
    faulty, _ = _tiny(tmp_path / "b", fail_at=(6,))
    _, _, st2 = tloop.run_with_restarts(*faulty, log=lambda s: None)
    assert st1.losses[-1] == pytest.approx(st2.losses[-1], rel=1e-4)


def test_loop_restarts_from_the_initial_state_without_a_checkpoint(tmp_path):
    """A fault before the first checkpoint restarts from the initial
    weights, as the reference's immutable parameters do: the same final
    loss as a clean run."""
    clean, _ = _tiny(tmp_path / "a", steps=4)
    _, _, st1 = tloop.run_with_restarts(*clean, log=lambda s: None)
    faulty, _ = _tiny(tmp_path / "b", fail_at=(2,), steps=4)
    _, _, st2 = tloop.run_with_restarts(*faulty, log=lambda s: None)
    assert st2.restarts == 1 and st2.step == 4
    assert st2.losses == pytest.approx(st1.losses, rel=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_resume(tmp_path, writer):
    """One package's loop runs 4 steps and checkpoints; the other's loop
    resumes from that checkpoint to step 8. The resumed losses equal the
    writer's own unbroken 8-step run's."""
    runs = {"jax": jloop.run_with_restarts, "torch": tloop.run_with_restarts}
    reader = "torch" if writer == "jax" else "jax"

    def args(path, steps):
        port, ref = _tiny(tmp_path / path, steps=steps)
        return {"torch": port, "jax": ref}

    runs[writer](*args("w", 4)[writer], log=lambda s: None)
    _, _, st = runs[reader](*args("w", 8)[reader], log=lambda s: None)
    assert st.step == 8 and len(st.losses) == 4
    assert jckpt.available_steps(str(tmp_path / "w" / "ck")) == [4, 8]
    _, _, want = runs[writer](*args("u", 8)[writer], log=lambda s: None)
    np.testing.assert_allclose(st.losses, want.losses[4:], rtol=1e-4)


# ----------------------------- launcher and example ----------------------


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    st = main(["--arch", "xlstm-125m", "--smoke", "--steps", "6",
               "--batch", "2", "--seq", "32", "--device", "cpu",
               "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
               "--fail-at", "3"])
    assert st.step == 6 and st.restarts == 1
    assert all(np.isfinite(st.losses))
    out = capsys.readouterr().out
    assert "restored step 2" in out and "finished 6 steps (1 restarts" in out
    assert main(["--arch", "granite-34b", "--plan-only", "--chips",
                 "64"]) is None
    assert "mesh plans for granite-34b @ 64 chips" in capsys.readouterr().out


def test_train_example_on_the_cpu(tmp_path):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    st = mod.main(["--arch", "mixtral-8x7b", "--smoke", "--steps", "3",
                   "--batch", "2", "--seq", "16", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    assert st.step == 3 and all(np.isfinite(st.losses))
