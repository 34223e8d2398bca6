"""The port's parallel substrate (``src/repro_torch/parallel/``,
``launch/mesh.py``) against the JAX package on the CPU.

The reference's mesh cases run once, in one subprocess with 8 forced host
devices (as ``tests/test_parallel.py`` runs them), on seeded numpy inputs
that the subprocess saves beside its outputs: ``moe_ep_apply`` at (data 2,
model 4) and at (4, 2) with FSDP over ``data``, at the reduced Mixtral's
widths with capacity factor 1.0 so that tokens drop; ``pipelined_forward``
on the toy stack of ``tests/test_parallel.py``; ``compressed_psum`` with
each scheme over 8 workers. The port runs the same inputs on the logical
mesh ``["cpu"] * 8``. Tolerances: f32 ``rtol 2e-5, atol 2e-6``, the
reference's own; the int8 payloads and the dropped assignments exactly.

In process, without a mesh: the two-stage ``moe_apply`` at each
``dp_size`` against the reference's; every arch's parameter and cache
specs at full width (the reference through ``jax.eval_shape``, the port on
the ``meta`` device); the mesh helpers; the port's own invariants (the
pipelined reduced Qwen3 stack and every remat policy bitwise equal to the
plain run, the all-to-all dispatch against the two-stage one).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.launch import mesh as jmesh
from repro.models import layers as jl
from repro.models import registry as jreg
from repro.parallel import hints as jhints
from repro.parallel import sharding as jsh
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.interop import leaf_parts, param_tree
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tl
from repro_torch.models import registry
from repro_torch.models import transformer as tt
from repro_torch.models import zamba2 as tz
from repro_torch.parallel import hints
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.compression import (
    CompressionConfig,
    compress_int8,
    compress_topk,
    compressed_psum,
    init_residuals,
    payload_bytes,
)
from repro_torch.parallel.moe_ep import moe_ep_apply
from repro_torch.parallel.pipeline import (
    pipeline_utilization,
    pipelined_forward,
    stack_stage_params,
)
from repro_torch.train.checkpoint import tree_flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32, the reference's own tests' tolerance for its mesh cases.
TOL = dict(rtol=2e-5, atol=2e-6)
#: The MoE meshes: (data, model) and the FSDP axes.
EP_MESHES = {"2x4": ((2, 4), None), "4x2_fsdp": ((4, 2), ("data",))}

_REFERENCE = """
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.compat import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import get_arch
from repro.parallel.compression import (CompressionConfig, compress_int8,
    compressed_psum)
from repro.parallel.moe_ep import moe_ep_apply
from repro.parallel.pipeline import pipelined_forward, stack_stage_params

out = {}
auto = lambda n: (AxisType.Auto,) * n
rng = np.random.default_rng(0)

# moe_ep_apply at the reduced Mixtral's widths, capacity factor 1.0
cfg = get_arch('mixtral-8x7b').reduced()
m = cfg.moe
n, d, e, f = 64, cfg.d_model, m.n_experts, m.d_ff
xt = rng.standard_normal((n, d)).astype(np.float32)
router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
w_gate = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
w_up = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
w_down = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(router), -1)
gates, idx = jax.lax.top_k(probs, m.top_k)
gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
out.update(moe_xt=xt, moe_idx=np.asarray(idx), moe_gates=np.asarray(gates),
           moe_w_gate=w_gate, moe_w_up=w_up, moe_w_down=w_down)
for key, (shape, fsdp) in EP_MESHES.items():
    mesh = jax.make_mesh(shape, ('data', 'model'), axis_types=auto(2))
    got = moe_ep_apply(jnp.asarray(xt), idx, gates, jnp.asarray(w_gate),
                       jnp.asarray(w_up), jnp.asarray(w_down), mesh=mesh,
                       dp_axes=('data',), ep_axis='model', fsdp_axes=fsdp,
                       capacity_factor=1.0, top_k=m.top_k, n_experts=e)
    out['moe_' + key] = np.asarray(got)

# pipelined_forward on tests/test_parallel.py's toy stack
L, D, M, MB = 16, 32, 6, 4
w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
micro = rng.standard_normal((M, MB, D)).astype(np.float32)

def stage_fn(stage_w, x):
    def body(c, wl):
        return jnp.tanh(c @ wl), None
    return jax.lax.scan(body, x, stage_w)[0]

mesh = jax.make_mesh((8,), ('stage',), axis_types=auto(1))
run = pipelined_forward(mesh, stage_fn)
out.update(pipe_w=w, pipe_micro=micro,
           pipe_out=np.asarray(run(stack_stage_params(jnp.asarray(w), 8),
                                   jnp.asarray(micro))))

# compressed_psum over 8 workers, each scheme, residuals not zero
g = (rng.standard_normal((8, 3, 200)) * 0.1).astype(np.float32)
r = (rng.standard_normal((8, 3, 200)) * 0.01).astype(np.float32)
out.update(psum_g=g, psum_r=r)
mesh = jax.make_mesh((8,), ('data',), axis_types=auto(1))
for scheme in ('none', 'int8_ef', 'topk_ef'):
    cfgc = CompressionConfig(scheme)
    f = jax.jit(shard_map(
        lambda gs, rs: compressed_psum(gs, rs, 'data', cfgc), mesh=mesh,
        in_specs=(P('data', None, None), P('data', None, None)),
        out_specs=(P(None), P('data', None, None))))
    mean, new_r = f({'w': jnp.asarray(g)}, {'w': jnp.asarray(r)})
    out['psum_mean_' + scheme] = np.asarray(mean['w'])
    out['psum_res_' + scheme] = np.asarray(new_r['w'])
qs = [compress_int8(jnp.asarray(g[i:i + 1]), jnp.asarray(r[i:i + 1]))[0]
      for i in range(8)]
out['int8_q'] = np.stack([np.asarray(q) for q, _ in qs])
out['int8_scale'] = np.stack([np.asarray(s) for _, s in qs])
np.savez(sys.argv[1], **out)
print('reference OK')
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's mesh cases, run once in a subprocess with 8 forced
    host devices; their inputs and outputs as a dict of numpy arrays."""
    path = tmp_path_factory.mktemp("parallel") / "reference.npz"
    code = f"EP_MESHES = {EP_MESHES!r}\n" + textwrap.dedent(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# Against the reference on a mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(EP_MESHES))
def test_moe_ep_apply_equals_the_reference(reference, key):
    """The all-to-all dispatch at both meshes, drops included: the
    reduced Mixtral's 4 experts at capacity factor 1.0 over 8 ranks of 8
    tokens (cap 4)."""
    shape, fsdp = EP_MESHES[key]
    mesh = tmesh.make_mesh(shape, ("data", "model"), ["cpu"] * 8)
    r = reference
    k, e = r["moe_idx"].shape[1], r["moe_w_gate"].shape[0]
    got = moe_ep_apply(
        _t(r["moe_xt"]), _t(r["moe_idx"]).long(), _t(r["moe_gates"]),
        _t(r["moe_w_gate"]), _t(r["moe_w_up"]), _t(r["moe_w_down"]),
        mesh=mesh, dp_axes=("data",), ep_axis="model", fsdp_axes=fsdp,
        capacity_factor=1.0, top_k=k, n_experts=e)
    _close(got, r["moe_" + key])
    stats = moe_ep_apply.last
    assert stats["cap"] == 4 and stats["n_loc"] == 8
    assert int(stats["dropped"].sum()) > 0  # the drop path is held too
    # each all-to-all copies E·cap·d per rank, both ways
    per_rank = e * stats["cap"] * r["moe_xt"].shape[1] * 4
    assert stats["a2a_bytes"] == (8 * per_rank, 8 * per_rank)


def test_pipelined_forward_equals_the_reference(reference):
    r = reference
    mesh = tmesh.make_mesh((8,), ("stage",), ["cpu"] * 8)

    def stage_fn(stage_w, x):
        for wl in stage_w:
            x = torch.tanh(x @ wl)
        return x

    run = pipelined_forward(mesh, stage_fn)
    stages = stack_stage_params(_t(r["pipe_w"]), 8)
    got = run(stages, _t(r["pipe_micro"]))
    _close(got, r["pipe_out"])
    tree = stack_stage_params({"w": _t(r["pipe_w"])}, 8)
    assert torch.equal(pipelined_forward(mesh, lambda p, x: stage_fn(
        p["w"], x))(tree, _t(r["pipe_micro"])), got)
    # 6 microbatches through 8 stages: 13 ticks, 48 stage calls, none on
    # an idle (stage, tick); 7 hand-offs of 4x32 f32 at the full ticks
    assert run.last["ticks"] == 13 and run.last["stage_calls"] == 48
    assert max(run.last["handoff_bytes"]) == 6 * 4 * 32 * 4
    assert abs(pipeline_utilization(6, 8) - 6 / 13) < 1e-9


@pytest.mark.parametrize("scheme", ["none", "int8_ef", "topk_ef"])
def test_compressed_psum_equals_the_reference(reference, scheme):
    r = reference
    g, res = r["psum_g"], r["psum_r"]
    grads = [{"w": _t(g[i:i + 1])} for i in range(8)]
    resid = [{"w": _t(res[i:i + 1])} for i in range(8)]
    mean, new_r = compressed_psum(grads, resid, CompressionConfig(scheme))
    _close(mean["w"], r["psum_mean_" + scheme])
    _close(torch.cat([x["w"] for x in new_r]), r["psum_res_" + scheme])
    if scheme == "int8_ef":
        for i in range(8):
            (q, scale), _, _ = compress_int8(grads[i]["w"], resid[i]["w"])
            np.testing.assert_array_equal(q.numpy(), r["int8_q"][i])
            assert float(scale) == float(r["int8_scale"][i])


# --------------------------------------------------------------------------
# Against the reference in process
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dp_size", [1, 4, 7, 8])
def test_two_stage_moe_apply_equals_the_reference(dp_size):
    """The block dispatch at ``hint("dp_size")``, capacity factor 1.0 over
    64 tokens: 7 does not divide them and falls back to one block."""
    jc = jax_get_arch("mixtral-8x7b").reduced()
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=1.0))
    tc = get_arch("mixtral-8x7b").reduced()
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=1.0))
    jp = jax.tree_util.tree_map(np.asarray, jl.moe_init(
        jax.random.PRNGKey(3), jc))
    moe = tl.MoE(tc, device="cpu")
    with torch.no_grad():
        for name, value in jp.items():
            getattr(moe, name).copy_(_t(value))
    x = np.random.default_rng(dp_size).standard_normal(
        (2, 32, tc.d_model)).astype(np.float32)
    with jhints.sharding_hints(dp_size=dp_size):
        want = jl.moe_apply(jp, jnp.asarray(x), jc)
    with hints.sharding_hints(dp_size=dp_size):
        got = tl.moe_apply(moe, _t(x), tc)
        nblk = dp_size if 64 % dp_size == 0 else 1
        keep = tl.moe_route(moe, _t(x).reshape(64, -1), tc, nblk)[3]
    _close(got, want, dict(rtol=1e-5, atol=1e-6))
    assert not bool(keep.all())  # tokens dropped, per block


def _jax_tree(cfg):
    bundle = jreg.build(cfg)
    return (jax.eval_shape(bundle.init, jax.random.PRNGKey(0)),
            jax.eval_shape(lambda: bundle.cache_init(32, 64)))


def _port_tree(cfg):
    cls = {"hybrid": tz.Zamba2, "ssm": registry.XLSTM}.get(cfg.family,
                                                           tt.Transformer)
    bundle = registry.build(cfg, device="meta")
    return param_tree(cls(cfg, device="meta")), bundle.cache_init(32, 64)


def _by_path(tree):
    """{"k1/k2": spec as a tuple} of a specs tree of either package."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, (tsh.P, jax.sharding.PartitionSpec)))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec)
    return out


#: (axis sizes, fsdp axes, expert_cols_axis): the production mesh, the
#: multi-pod FSDP layout, the 2-D expert sharding of inference.
SPEC_CASES = {
    "16x16": ({"data": 16, "model": 16}, None, None),
    "multipod_fsdp": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"),
                      None),
    "expert_cols": ({"data": 16, "model": 16}, None, "data"),
}


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_and_cache_specs_equal_the_reference(name):
    """Every leaf's spec of every arch at full width, in each layout, and
    the cache's at batch 32 (dp) and at batch 1 (the sequence takes dp)."""
    jcfg, tcfg = jax_get_arch(name), get_arch(name)
    jparams, jcache = _jax_tree(jcfg)
    tparams, tcache = _port_tree(tcfg)
    n_exp = tcfg.moe.n_experts if tcfg.moe else 0
    for sizes, fsdp, cols in SPEC_CASES.values():
        kw = dict(n_experts=n_exp, model_axis_size=sizes["model"],
                  axis_sizes=sizes, fsdp_axes=fsdp, expert_cols_axis=cols)
        want = _by_path(jsh.build_param_specs(jparams, **kw))
        got = _by_path(tsh.build_param_specs(tparams, **kw))
        assert got == want
        dp = ("pod", "data") if "pod" in sizes else ("data",)
        kw = dict(dp_axes=dp, n_kv_heads=tcfg.n_kv_heads,
                  model_axis_size=sizes["model"], axis_sizes=sizes)
        want = _by_path(jsh.build_cache_specs(jcache, **kw))
        assert _by_path(tsh.build_cache_specs(tcache, **kw)) == want
        # cache_pspec on the reference's own (path, shape) pairs, batch 1
        flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        for path, leaf in flat:
            ps = jsh._path_str(path)
            one = types.SimpleNamespace(shape=(1,) + leaf.shape[1:]) \
                if len(leaf.shape) < 5 else types.SimpleNamespace(
                    shape=leaf.shape[:1] + (1,) + leaf.shape[2:])
            assert tuple(tsh.cache_pspec(ps, one, **kw)) == tuple(
                jsh.cache_pspec(path, one, **kw))


def test_mesh_helpers_equal_the_reference():
    """``mesh_axis_sizes`` and ``dp_axes_for`` on the production meshes
    (the reference's on stand-ins of its meshes: no 256 devices here)."""
    for multi in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert len(mesh.devices) == (512 if multi else 256)
        assert {d.type for d in mesh.devices} == {"meta"}
        stand_in = types.SimpleNamespace(
            axis_names=mesh.axis_names,
            devices=np.empty(mesh.axis_sizes, dtype=object))
        assert tmesh.mesh_axis_sizes(mesh) == jmesh.mesh_axis_sizes(stand_in)
        for batch in (1, 16, 24, 32, 48, 256):
            assert tmesh.dp_axes_for(mesh, batch) == jmesh.dp_axes_for(
                stand_in, batch)


# --------------------------------------------------------------------------
# The port's own invariants
# --------------------------------------------------------------------------


def test_shard_is_a_view_and_unshard_joins_bitwise():
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    x = torch.randn(8, 12, 6)
    for spec in (tsh.P("model", ("data",), None), tsh.P(("data", "model")),
                 tsh.P(None, "data"), tsh.P()):
        pieces = tsh.shard(x, spec, mesh)
        assert len(pieces) == 8
        for p in pieces:  # a view into x's storage, never a copy
            assert p.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr()
        assert torch.equal(tsh.unshard(pieces, spec, mesh), x)
    # rank (i, j) of the (data, model) mesh takes block i * 4 + j
    pieces = tsh.shard(x, tsh.P(("data", "model")), mesh)
    assert torch.equal(pieces[mesh.rank({"data": 1, "model": 2})], x[6:7])
    with pytest.raises(ValueError):
        tsh.shard(x, tsh.P(None, None, "model"), mesh)


def test_constrain_and_hints():
    calls = []

    def spec_fn(h):
        calls.append(h)
        return tsh.P("data")

    x = torch.ones(2)
    assert hints.constrain(x, spec_fn) is x and calls == []
    assert not hints.hints_active()
    with hints.sharding_hints(dp=("data",)):
        assert hints.hints_active() and hints.hint("dp") == ("data",)
        assert hints.constrain(x, spec_fn) is x
    assert calls == [{"dp": ("data",)}] and hints.hint("dp") is None
    wrapped = hints.with_hints(lambda: hints.hint("remat"), remat="dots")
    assert wrapped() == "dots" and hints.hint("remat") is None


def _reduced_mixtral(cf):
    cfg = get_arch("mixtral-8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.mark.parametrize("key", sorted(EP_MESHES))
def test_all_to_all_dispatch_equals_the_two_stage_one(key):
    """``moe_apply`` under the a2a hints on ``["cpu"] * 8`` against the
    two-stage dispatch at ``dp_size`` 8: the same per-rank capacities,
    so the same drops (the reference shows this relation too)."""
    shape, fsdp = EP_MESHES[key]
    cfg = _reduced_mixtral(1.0)
    moe = tl.MoE(cfg, device="cpu")
    moe.init_weights(cfg, torch.Generator().manual_seed(1))
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    mesh = tmesh.make_mesh(shape, ("data", "model"), ["cpu"] * 8)
    with hints.sharding_hints(ep="model", ep_size=shape[1], dp=("data",),
                              dp_size=shape[0], a2a=mesh, fsdp=fsdp):
        got = tl.moe_apply(moe, x, cfg)
    dropped = moe_ep_apply.last["dropped"]
    with hints.sharding_hints(dp_size=8):
        want = tl.moe_apply(moe, x, cfg)
        keep = tl.moe_route(moe, x.reshape(64, -1), cfg, 8)[3]
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(dropped, (~keep).view(8, -1).sum(1))
    assert int(dropped.sum()) > 0


def test_pipelined_qwen3_stack_is_bitwise_the_sequential_one():
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), n_layers=4)
    model = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    micro = torch.randn((3, 1, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16)[None]

    def stage_fn(layers, x):
        for layer in layers:
            x = layer(x, cfg, pos)
        return x

    for stages in (2, 4):
        mesh = tmesh.make_mesh((stages,), ("stage",), ["cpu"] * stages)
        run = pipelined_forward(mesh, stage_fn)
        with torch.no_grad():
            got = run(stack_stage_params(model.layers, stages), micro)
            want = torch.stack([stage_fn(model.layers, x) for x in micro])
        assert torch.equal(got, want)
        assert run.last["stage_calls"] == 3 * stages
    with pytest.raises(ValueError):
        stack_stage_params(model.layers, 3)
    with pytest.raises(ValueError):
        stack_stage_params(torch.zeros(4, 2), 3)


def _grads(bundle, model, batch):
    parts = [x for leaf in tree_flatten(param_tree(model))[0]
             for x in leaf_parts(leaf)]
    for p in parts:
        p.requires_grad_(True)
    loss = bundle.loss(model, batch)
    return loss, torch.autograd.grad(loss, parts)


@pytest.mark.parametrize("name", ["qwen3-8b", "mixtral-8x7b"])
def test_remat_policies_give_bitwise_the_gradients_without_remat(name):
    cfg = get_arch(name).reduced()
    bundle = registry.build(cfg, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("t", 32, 2, "train"), 0,
                                "cpu")
    with hints.sharding_hints(remat="off"):
        loss0, want = _grads(bundle, model, batch)
    for policy in ("none", "dots", "sublayers", None):
        ctx = (hints.sharding_hints(remat=policy) if policy
               else hints.sharding_hints())
        with ctx:
            loss, got = _grads(bundle, model, batch)
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_step_dp_axes_changes_no_value():
    from repro_torch.train.optimizer import AdamWConfig, init_state

    cfg = get_arch("qwen3-8b").reduced()
    bundle = registry.build(cfg, device="cpu")
    batch = registry.make_batch(cfg, ShapeConfig("t", 16, 4, "train"), 0,
                                "cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for dp_axes in (None, ("data",)):
        model = bundle.init(torch.Generator().manual_seed(0))
        opt = init_state(opt_cfg, param_tree(model))
        step = bundle.make_train_step(opt_cfg, num_microbatches=2,
                                      dp_axes=dp_axes)
        model, opt, metrics = step(model, opt, batch)
        runs.append((metrics["loss"], tree_flatten(param_tree(model))[0]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert all(torch.equal(x, y) for x, y in zip(leaf_parts(a),
                                                     leaf_parts(b)))


def test_compression_bounds_and_payloads():
    """int8: the mean within sum(scale_r) / (2R) of the exact mean, each
    residual x - deq exactly; top-k: deq + residual == x bitwise."""
    gen = torch.Generator().manual_seed(5)
    grads = [{"a": torch.randn(40, 30, generator=gen),
              "b": [torch.randn(7, generator=gen)]} for _ in range(2)]
    res = [init_residuals(g) for g in grads]
    exact, _ = compressed_psum(grads, res, CompressionConfig("none"))
    assert torch.equal(exact["a"], (grads[0]["a"] + grads[1]["a"]) / 2)
    mean, new_r = compressed_psum(grads, res, CompressionConfig("int8_ef"))
    scales = [compress_int8(g["a"], r["a"])[0][1] for g, r in zip(grads,
                                                                  res)]
    bound = sum(float(s) for s in scales) / 4
    assert float((mean["a"] - exact["a"]).abs().max()) <= bound
    for g, r, nr in zip(grads, res, new_r):
        _, deq, _ = compress_int8(g["a"], r["a"])
        assert torch.equal(nr["a"], g["a"] + r["a"] - deq)
    for g, r in zip(grads, res):
        _, deq, nr = compress_topk(g["a"], r["a"], 0.01)
        assert torch.equal(deq + nr, g["a"] + r["a"])
        assert int((deq != 0).sum()) == 12
    n = 40 * 30 + 7
    assert payload_bytes(grads[0], CompressionConfig("none")) == 2 * n
    assert payload_bytes(grads[0], CompressionConfig("int8_ef")) == n + 8
    assert payload_bytes(grads[0], CompressionConfig("topk_ef")) == 8 * 12
