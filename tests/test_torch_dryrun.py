"""The port's cost analysis and dry run (``launch/hlo_cost.py``,
``launch/dryrun.py``) against the JAX package's on the CPU, and Zamba2's
remat.

The cost-mode cases are the reference's ``tests/test_hlo_cost.py`` as
torch loops: each equals the analytic count exactly and the reference's
``analyze_hlo`` of the same function within that test's 1%. Flop parity:
a prefill, a decode and a train step (2 microbatches) of each family at
its reduced config, traced on ``meta``, against ``analyze_hlo`` of the
reference's compiled step on one device, within 1% once the one named
difference (the port's block-diagonal sLSTM product,
:func:`_named_difference`) is taken off. The reference's small-mesh
cell (``tests/test_parallel.py``: Mixtral reduced to 2 layers, train
32x8, a (data 2, model 4) mesh) runs once in a subprocess with 8 forced
host devices: every leaf's rank-0 shard shape and the summed argument
bytes equal the port's; the port's ``from_specs`` census equals a hand
sum from the specs, and the reference's HLO collective census, split by
origin, equals it where the port prices the same collectives, each
difference named (``REFERENCE_ORIGINS``, ``UNPRICED``).
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.hlo_cost import analyze_hlo
from repro.models import registry as jreg
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_state as jinit_state
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.interop import leaf_parts, param_tree
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch.hlo_cost import CostMode, analyze, record_collective
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry
from repro_torch.models import zamba2 as tz
from repro_torch.parallel import hints
from repro_torch.parallel.compression import (
    CompressionConfig,
    compressed_psum,
)
from repro_torch.parallel.moe_ep import moe_ep_apply
from repro_torch.parallel.pipeline import pipelined_forward
from repro_torch.parallel.sharding import P, build_param_specs
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.train.optimizer import AdamWConfig, init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
WANT10 = 2 * 128 * 256 * 256 * 10


# --------------------------------------------------------------------------
# The cost mode: tests/test_hlo_cost.py as torch loops
# --------------------------------------------------------------------------


def _jax_flops(f):
    x = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    w = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    return analyze_hlo(jax.jit(f).lower(x, w).compile().as_text()).flops


def _xw():
    return (torch.empty(128, 256, device=META),
            torch.empty(256, 256, device=META))


def test_repeat_region_scales_the_body():
    def body(x, w):
        return torch.tanh(x @ w)

    x, w = _xw()
    with CostMode() as mode:
        with mode.repeat(10):
            body(x, w)
    assert mode.flops == WANT10 and mode.n_whiles == 1

    def jf(x, w):
        return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                            length=10)[0]

    assert abs(_jax_flops(jf) - mode.flops) / WANT10 < 0.01


def test_unrolled_loop_equals_the_region():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    cost = analyze(f, *_xw())
    assert cost.flops == WANT10 and cost.n_whiles == 0

    def jf(x, w):
        for _ in range(10):
            x = jnp.tanh(x @ w)
        return x

    assert abs(_jax_flops(jf) - cost.flops) / WANT10 < 0.01


def test_nested_regions_multiply():
    x, w = _xw()
    with CostMode() as mode:
        with mode.repeat(4):
            with mode.repeat(5):
                x @ w
    want = 2 * 128 * 256 * 256 * 20
    assert mode.flops == want and mode.n_whiles == 2

    def jf(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda ci, _: (ci @ w, None), c, None,
                                length=5)[0], None

        return jax.lax.scan(outer, x, None, length=4)[0]

    assert abs(_jax_flops(jf) - want) / want < 0.01


def test_collectives_counted_inside_regions():
    with CostMode() as mode:
        with mode.repeat(7):
            record_collective("all-reduce", 64 * 4, 64)
    cost = mode.cost()
    assert cost.coll_bytes == 7 * 64 * 4 and cost.coll_elems == 7 * 64
    assert cost.coll_counts == {"all-reduce": 7}
    record_collective("all-reduce", 1, 1)  # no mode: nothing, no error
    with pytest.raises(ValueError):
        mode.record_collective("all-sum", 1, 1)


def test_hbm_proxy_and_liveness():
    """Views and allocations that write nothing move no bytes; in-place
    ops write theirs; a freed temporary leaves the live bytes."""
    x = torch.zeros(64, 64)
    with CostMode() as mode:
        a = x @ x  # 16 KiB written, allocated
        a.t().select(0, 1).view(-1)  # views
        torch.empty(1024)
        a.add_(1.0)  # 16 KiB written in place, no allocation
        del a
        b = x + 1  # 16 KiB
    assert mode.hbm_proxy_bytes == 3 * 64 * 64 * 4
    assert mode.peak_bytes == 64 * 64 * 4 + 4096
    assert mode.live_bytes == 64 * 64 * 4
    del b
    assert mode.live_bytes == 0


def test_train_step_region_equals_the_unrolled_loop(monkeypatch):
    """make_train_step's microbatch loop folded into one region (the dry
    run's) costs what the unrolled loop costs."""
    cfg = get_arch("qwen3-8b").reduced()
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = Mesh((1, 1), ("data", "model"), [META])
    folded = dryrun.dry_run(cfg, shape, mesh, num_microbatches=4)
    monkeypatch.setattr(hlo_cost, "loop",
                        lambda n: (n, contextlib.nullcontext()))
    unrolled = dryrun.dry_run(cfg, shape, mesh, num_microbatches=4)
    assert folded["hlo_cost"]["n_whiles"] == 1
    assert unrolled["hlo_cost"]["n_whiles"] == 0
    for key in ("flops", "hbm_proxy_bytes"):
        assert folded["hlo_cost"][key] == unrolled["hlo_cost"][key]
    assert hlo_cost.CostMode().fold is False  # a plain count never folds


# --------------------------------------------------------------------------
# Explicit collectives: each reports what it moves
# --------------------------------------------------------------------------


def test_explicit_collectives_report_their_bytes():
    cfg = get_arch("mixtral-8x7b").reduced()
    n, d, e, f, k = 64, cfg.d_model, 4, cfg.moe.d_ff, 2
    mesh = Mesh((2, 4), ("data", "model"), [META] * 8)
    xt = torch.empty(n, d, device=META, requires_grad=True)
    idx = torch.zeros(n, k, dtype=torch.int64, device=META)
    gates = torch.empty(n, k, device=META)
    ws = [torch.empty(shape, device=META, requires_grad=True)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    with CostMode() as mode:
        out = moe_ep_apply(xt, idx, gates, *ws, mesh=mesh,
                           dp_axes=("data",), ep_axis="model",
                           fsdp_axes=("data",), capacity_factor=1.0,
                           top_k=k, n_experts=e)
        forward = {k: dict(v) for k, v in mode.collectives.kinds.items()}
        torch.autograd.grad(out.sum(), (xt, *ws))
    a2a = sum(moe_ep_apply.last["a2a_bytes"])
    assert forward["all-to-all"] == {"count": 2, "bytes": a2a,
                                     "elems": a2a // 4}
    # each of the 8 ranks gathers its expert's three (1, d, f) weights,
    # one all-gather each; the backward reduce-scatters their gradients
    # over the 2 data ranks and sends the tokens' gradients back through
    # two all-to-alls
    assert forward["all-gather"] == {
        "count": 3, "bytes": 8 * 3 * d * f * 4, "elems": 8 * 3 * d * f}
    kinds = mode.collectives.kinds
    assert kinds["all-to-all"] == {"count": 4, "bytes": 2 * a2a,
                                   "elems": 2 * a2a // 4}
    assert kinds["reduce-scatter"] == {
        "count": 3, "bytes": 8 * 3 * d * f * 4 // 2,
        "elems": 8 * 3 * d * f // 2}

    stage = Mesh((4,), ("stage",), ["cpu"] * 4)
    run = pipelined_forward(stage, lambda w, x: torch.tanh(x @ w))
    with CostMode() as mode:
        run([torch.eye(8)] * 4, torch.ones(3, 2, 8))
    permute = mode.collectives.kinds["collective-permute"]
    assert permute["bytes"] == sum(run.last["handoff_bytes"])
    assert permute["count"] == sum(1 for b in run.last["handoff_bytes"] if b)

    grads = [{"w": torch.ones(3, 10)} for _ in range(4)]
    res = [{"w": torch.zeros(3, 10)} for _ in range(4)]
    for scheme, per_rank in (("none", 120), ("int8_ef", 30 + 4),
                             ("topk_ef", 4 * 3 + 8 * 3)):
        with CostMode() as mode:
            compressed_psum(grads, res, CompressionConfig(scheme, 0.1))
        assert mode.collectives.kinds["all-reduce"]["bytes"] == 4 * per_rank


# --------------------------------------------------------------------------
# Flop parity with the reference, per family
# --------------------------------------------------------------------------

FAMILIES = ("qwen3-8b", "mixtral-8x7b", "zamba2-7b", "xlstm-125m",
            "whisper-medium", "llava-next-34b")
SHAPES = {"prefill": ShapeConfig("p", 64, 2, "prefill"),
          "decode": ShapeConfig("d", 64, 2, "decode"),
          "train": ShapeConfig("t", 64, 4, "train")}
#: Per family, the reduced config's changes: xLSTM's reduced two blocks
#: are both mLSTM by the default pattern, so an sLSTM block is asked for.
CHANGES = {"xlstm-125m": dict(block_pattern=("mlstm", "slstm"))}


def _named_difference(cfg, shape: ShapeConfig) -> float:
    """The flops the port does that the reference does not. The port's
    sLSTM runs its per-head recurrent weights ``(H, dh, 4 dh)`` as one
    block-diagonal ``(d, 4d)`` product a position (models/xlstm.py
    ``_recurrent``): ``2 B d 4d`` flops where the reference's per-head
    einsum does ``2 B d 4dh``; a train step runs that product three
    times (the forward and the two products of its backward)."""
    if cfg.family != "ssm":
        return 0.0
    d, dh = cfg.d_model, cfg.d_model // cfg.n_heads
    n_slstm = sum(k == "slstm" for k in registry._xlstm_pattern(cfg))
    positions = shape.seq_len if shape.kind != "decode" else 1
    per_block = 2 * shape.global_batch * positions * 4 * d * (d - dh)
    return n_slstm * per_block * (3 if shape.kind == "train" else 1)


def _reference_flops(name: str, shape: ShapeConfig) -> float:
    cfg = dataclasses.replace(jax_get_arch(name).reduced(),
                              **CHANGES.get(name, {}))
    bundle = jreg.build(cfg)
    params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
    specs = jreg.input_specs(cfg, JShapeConfig(*dataclasses.astuple(shape)))
    if shape.kind == "train":
        opt_cfg = JAdamWConfig(state_dtype=cfg.opt_state_dtype)
        opt = jax.eval_shape(lambda p: jinit_state(opt_cfg, p), params)
        fn = bundle.make_train_step(opt_cfg, num_microbatches=2)
        args = (params, opt, specs)
    elif shape.kind == "prefill":
        fn, args = bundle.make_prefill_step(), (params, specs)
    else:
        s = shape.seq_len if cfg.family != "audio" else shape.seq_len // 4
        cache = jax.eval_shape(lambda: bundle.cache_init(
            shape.global_batch, s))
        fn = bundle.make_decode_step()
        args = (params, specs["token"], cache, specs["pos"])
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("name", FAMILIES)
def test_flops_equal_the_reference(name, kind):
    shape = SHAPES[kind]
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              **CHANGES.get(name, {}))
    mesh = Mesh((1, 1), ("data", "model"), [META])
    art = dryrun.dry_run(cfg, shape, mesh, num_microbatches=2)
    got = art["hlo_cost"]["flops"]
    extra = _named_difference(cfg, shape)
    want = _reference_flops(name, shape)
    assert extra < got and abs(got - extra - want) / want <= 0.01, (
        got, extra, want)


# --------------------------------------------------------------------------
# The reference's small-mesh cell: shard shapes, argument bytes, census
# --------------------------------------------------------------------------

_REFERENCE = """
import os, sys, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import dataclasses, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.launch.hlo_cost import analyze_hlo
from repro.models import registry
from repro.models.registry import input_specs
from repro.parallel.sharding import build_param_specs
from repro.train.optimizer import AdamWConfig, init_state

cfg = dataclasses.replace(get_arch('mixtral-8x7b').reduced(), n_layers=2)
bundle = registry.build(cfg)
opt_cfg = AdamWConfig()
step = bundle.make_train_step(opt_cfg)
shape = ShapeConfig('t', 32, 8, 'train')
mesh = jax.make_mesh((2, 4), ('data', 'model'),
                     axis_types=(AxisType.Auto,) * 2)
params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
opt = jax.eval_shape(lambda p: init_state(opt_cfg, p), params)
pspecs = build_param_specs(params, n_experts=4, model_axis_size=4)
ospecs = {'m': pspecs, 'v': pspecs, 'step': P()}
batch = input_specs(cfg, shape)
bspecs = {k: P('data', None) for k in batch}
sh = lambda s: NamedSharding(mesh, s)
in_sh = (jax.tree.map(sh, pspecs), jax.tree.map(sh, ospecs),
         jax.tree.map(sh, bspecs))
with set_mesh(mesh):
    compiled = jax.jit(step, in_shardings=in_sh).lower(
        params, opt, batch).compile()
shards = {}
trees = {'params': (params, pspecs), 'opt': (opt, ospecs),
         'batch': (batch, bspecs)}
is_spec = lambda x: isinstance(x, P)
for name, (tree, specs) in trees.items():
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_specs = jax.tree_util.tree_flatten(specs, is_leaf=is_spec)[0]
    for (path, leaf), spec in zip(leaves, flat_specs):
        key = '/'.join([name] + [str(getattr(k, 'key', getattr(k, 'idx', k)))
                                 for k in path])
        shards[key] = list(sh(spec).shard_shape(leaf.shape))
text = compiled.as_text()
hc = analyze_hlo(text)


def origins(text):
    # each collective by (kind, origin): [ops, operands], an op counted once
    # per trip of its loop (analyze_hlo's fold), a tuple op's operands each
    import collections, re
    from repro.launch.hlo_cost import (_COLLECTIVES, _COMP_HDR_RE, _INSTR_RE,
                                       parse_hlo)
    comps = parse_hlo(text)
    trips = collections.Counter()

    def walk(name, m):
        trips[name] += m
        for callee, k in comps[name].calls:
            if callee in comps:
                walk(callee, m * k)

    walk(comps['__entry__'].name, 1)
    out, cur = {}, None
    for line in text.splitlines():
        hdr = _COMP_HDR_RE.match(line)
        if hdr and '{' in line:
            cur = hdr.group(1)
            continue
        m = _INSTR_RE.match(line)
        if not m or m.group(3).replace('-start', '') not in _COLLECTIVES:
            continue
        kind, shape = m.group(3).replace('-start', ''), m.group(2)
        name = re.search(r'op_name="([^"]*)"', line).group(1)
        tail = name.split('/')[-1]
        if 'vmap()' in name or tail in ('top_k', 'reduce_window_sum'):
            origin = 'moe dispatch'
        elif 'attention_chunked_ref' in name or (
                tail == 'gather' and '/while/' in name):
            origin = 'attention'
        elif '/while/' not in name and 'transpose' not in name:
            origin = 'loss'
        elif kind == 'all-reduce' and '<=[2,4]T(1,0)' in line:  # over data
            origin = 'gradients'
        elif (kind == 'all-reduce' and tail == 'dot_general'
              and shape.lstrip('(').startswith('f32[4,32,128]')):
            origin = 'products'  # (tokens a data rank, d) over model
        else:
            origin = 'sharded activations'
        row = out.setdefault(kind, {}).setdefault(origin, [0, 0])
        row[0] += trips[cur]
        row[1] += trips[cur] * (shape.count('[') if shape[0] == '(' else 1)
    return out


out = {'shards': shards,
       'argument_size_in_bytes':
           compiled.memory_analysis().argument_size_in_bytes,
       'census': {'coll_bytes': hc.coll_bytes, 'coll_counts': hc.coll_counts},
       'origins': origins(text)}
with open(sys.argv[1], 'w') as f:
    json.dump(out, f)
print('reference OK')
"""


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    """The reference's small-mesh cell, compiled once in a subprocess with
    8 forced host devices."""
    path = tmp_path_factory.mktemp("dryrun") / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                          str(path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    with open(path) as f:
        return json.load(f)


def _port_cell():
    """The same cell in the port: (fn, args, specs, info, trees, mesh)."""
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(), n_layers=2)
    bundle = registry.build(cfg, device="meta")
    model = bundle.init()
    params = param_tree(model)
    opt_cfg = AdamWConfig()
    opt = init_state(opt_cfg, params)
    pspecs = build_param_specs(params, n_experts=4, model_axis_size=4)
    ospecs = {"m": pspecs, "v": pspecs, "step": P()}
    batch = registry.input_specs(cfg, ShapeConfig("t", 32, 8, "train"))
    bspecs = {k: P("data", None) for k in batch}
    mesh = Mesh((2, 4), ("data", "model"), [META] * 8)
    info = {"model": model, "pspecs": pspecs, "opt_pspecs": pspecs,
            "num_microbatches": 1, "heavy": False}
    trees = {"params": (params, pspecs), "opt": (opt, ospecs),
             "batch": (batch, bspecs)}
    return (cfg, bundle.make_train_step(opt_cfg), (model, opt, batch),
            (pspecs, ospecs, bspecs), info, trees, mesh)


def test_shard_shapes_and_argument_bytes_equal_the_reference(small_cell):
    _, _, _, _, _, trees, mesh = _port_cell()
    got = {}
    for name, (tree, specs) in trees.items():
        for path, leaf, spec in dryrun._pairs(tree, specs, name):
            got[path] = list(dryrun.shard_shape(leaf.shape, spec, mesh))
    assert got == small_cell["shards"]
    assert dryrun.argument_bytes(trees.values(), mesh) == small_cell[
        "argument_size_in_bytes"]


#: The reference's HLO collectives in the small-mesh cell by origin, [ops,
#: operands] (``origins`` in ``_REFERENCE``). The port's ``from_specs``
#: prices ``products`` and ``gradients``; the other origins it does not,
#: for the reasons in ``UNPRICED``.
REFERENCE_ORIGINS = {
    "all-reduce": {"products": [7, 11], "gradients": [3, 18],
                   "sharded activations": [19, 19], "attention": [6, 12],
                   "moe dispatch": [8, 12], "loss": [6, 18]},
    "all-gather": {"sharded activations": [10, 10], "attention": [4, 4],
                   "moe dispatch": [26, 26], "loss": [1, 1]},
    "collective-permute": {"moe dispatch": [12, 12]},
    "all-to-all": {"moe dispatch": [12, 24]},
}
#: What the reference's SPMD partitioner inserts that the port's spec
#: census does not price, by origin, and why.
UNPRICED = {
    "sharded activations": "the partitioner keeps the residual stream's "
    "hidden dim sharded over model between products: all-gathers before "
    "the column-parallel products, all-reduces of the norms' sums and of "
    "the router's logits; the census takes activations whole on each "
    "model rank",
    "attention": "the 2 kv heads shard over pairs of the 4 model ranks: "
    "rope's gather and the chunked softmax's sums reduce over each pair",
    "moe dispatch": "the reference's scatter into and gather from the "
    "expert buffer, sharded over model and data: all-to-alls, permutes and "
    "gathers; the port's two-stage dispatch (no a2a hint in this cell) "
    "moves nothing between ranks",
    "loss": "the cross-entropy's max, sum and label gather over the "
    "model-sharded vocab (lm_head's columns), and the mean over data",
}


def test_census_from_specs_equals_a_hand_sum(small_cell):
    cfg, fn, args, specs, info, trees, mesh = _port_cell()
    art = dryrun.trace_cell(cfg, ShapeConfig("t", 32, 8, "train"), mesh, fn,
                            args, specs, info, dp_size=2)
    got = art["collectives"]["from_specs"]
    # One all-reduce of (128 tokens a rank, d) per product that contracts
    # a dim sharded over model: wo in the forward and in the remat
    # recompute, the backward's dx of wq, wk and wv (column-parallel) in
    # each layer, and of lm_head. The experts shard E, not a contracted
    # dim. Then every gradient leaf all-reduced over data (the optimizer
    # state is not dp-sharded in this cell), at its rank-0 shard.
    params, pspecs = trees["params"]
    products = cfg.n_layers * (2 + 3) + 1
    grads = [math.prod(dryrun.shard_shape(leaf.shape, spec, mesh))
             for _, leaf, spec in dryrun._pairs(params, pspecs)]
    want_bytes = products * 128 * cfg.d_model * 4 + 4 * sum(grads)
    assert got["all-reduce"]["count"] == products + len(grads)
    assert got["total_bytes"] == want_bytes
    print(f"port from_specs: {got['total_count']} collectives, "
          f"{got['total_bytes']} B; the reference's HLO census: "
          f"{small_cell['census']}")

    # Against the reference's census, kind by kind: the origins cover
    # every op it counts, and each count that differs is named.
    ref = small_cell["origins"]
    assert ref == REFERENCE_ORIGINS
    assert {k: sum(ops for ops, _ in v.values()) for k, v in ref.items()} \
        == small_cell["census"]["coll_counts"]
    # products: one operand per product the port prices; XLA's combiner
    # packs a layer's three backward dx (wq, wk, wv) into one op
    ops, operands = ref["all-reduce"]["products"]
    assert operands == products and ops == products - 2 * cfg.n_layers
    # gradients: the port all-reduces each of its leaves once; the
    # reference's layer scan reduces each non-expert layer leaf once per
    # layer, the expert stacks not at all (the dispatch's all-to-alls over
    # data leave their gradients whole), one scalar of the loss's backward
    # rides in the last op, and the combiner packs each layer's and the
    # top-level reductions into one op each
    paths = [path for path, _, _ in dryrun._pairs(params, pspecs)]
    layer = [p for p in paths if p.startswith("moe_layers/")]
    experts = [p for p in layer if "/moe/w_" in p]
    ops, operands = ref["all-reduce"]["gradients"]
    assert operands == (len(grads) + (cfg.n_layers - 1) * (
        len(layer) - len(experts)) - len(experts) + 1)
    assert ops == cfg.n_layers + 1
    # every other origin is one the port does not price
    assert set(got) - {"total_count", "total_bytes"} == {"all-reduce"}
    for kind, row in ref.items():
        unpriced = {o for o in row if o not in ("products", "gradients")}
        assert unpriced <= set(UNPRICED), (kind, unpriced)


# --------------------------------------------------------------------------
# The production mesh, shapes without weights
# --------------------------------------------------------------------------


class _LargestCpuTensor(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                self.largest = max(self.largest, t.numel() * t.element_size())
        return out


def test_production_decode_cell_allocates_nothing():
    with _LargestCpuTensor() as watch:
        art = dryrun.run_cell("qwen3-8b", "decode_32k", multi_pod=False,
                              save=False)
    assert watch.largest <= 2**20
    assert art["mesh"] == "pod16x16" and art["n_devices"] == 256
    mem, cost = art["memory"], art["hlo_cost"]
    assert 0 < mem["argument_size_in_bytes"] < 80e9
    assert cost["flops"] * 256 == cost["global"]["flops"] > 0
    assert art["collectives"]["from_specs"]["all-reduce"]["count"] == 72


def test_meta_init_draws_nothing():
    """Kimi K2's ~1T parameters built on meta: every parameter a meta
    tensor, none drawn (the counterpart of jax.eval_shape(init))."""
    cfg = get_arch("kimi-k2-1t-a32b")
    model = registry.build(cfg, device="meta").init(None)
    n = sum(p.numel() for p in model.parameters())
    assert all(p.device.type == "meta" for p in model.parameters())
    assert n == pytest.approx(cfg.num_params(), rel=1e-6)


# --------------------------------------------------------------------------
# Zamba2's remat
# --------------------------------------------------------------------------


def test_zamba2_remat_recomputes_and_keeps_the_gradients(monkeypatch):
    """Four layers in two groups and a tail layer: with remat (the
    default) each Mamba2 layer and each site of the shared block runs
    twice, and the gradients are bitwise those without remat."""
    cfg = dataclasses.replace(get_arch("zamba2-7b").reduced(), n_layers=5)
    assert tz.schedule(cfg) == (2, 2, 1)
    bundle = registry.build(cfg, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("t", 16, 1, "train"), 0,
                                "cpu")
    parts = [x for leaf in tree_flatten(param_tree(model))[0]
             for x in leaf_parts(leaf)]
    for p in parts:
        p.requires_grad_(True)
    calls = {"mamba": 0, "shared": 0}
    apply = tz.mamba2_apply
    forward = type(model.shared).forward

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tz, "mamba2_apply", count("mamba", apply))
    monkeypatch.setattr(type(model.shared), "forward",
                        count("shared", forward))
    runs = {}
    for policy in ("off", None):
        for key in calls:
            calls[key] = 0
        ctx = (hints.sharding_hints(remat=policy) if policy
               else hints.sharding_hints())
        with ctx:
            loss = bundle.loss(model, batch)
            grads = torch.autograd.grad(loss, parts)
        runs[policy] = (loss, grads, dict(calls))
    assert runs["off"][2] == {"mamba": 5, "shared": 2}
    assert runs[None][2] == {"mamba": 10, "shared": 4}
    assert torch.equal(runs["off"][0], runs[None][0])
    assert all(torch.equal(a, b) for a, b in zip(runs["off"][1],
                                                 runs[None][1]))
    # serving records no graph and recomputes nothing
    for key in calls:
        calls[key] = 0
    bundle.forward(model, {"tokens": batch["tokens"]})
    assert calls == {"mamba": 5, "shared": 2}


def test_cli_runs_one_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "[dryrun]   ok: trace" in out and "all cells traced" in out
    with open(tmp_path / "xlstm-125m__decode_32k__pod16x16.json") as f:
        art = json.load(f)
    for key in ("arch", "shape", "mesh", "n_devices", "kind", "seq_len",
                "global_batch", "num_microbatches", "fsdp", "memory",
                "collectives", "hlo_cost", "model_params", "active_params",
                "trace_s"):
        assert key in art
    assert "coll_bytes_dtype" in art["hlo_cost"]
    dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--resume"])
    assert "skip (exists)" in capsys.readouterr().out
