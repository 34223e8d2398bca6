"""Per-rank dry run of every (architecture x input shape) cell on the
production mesh, traced on the ``meta`` device (the port of the JAX
package's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step ahead of time against
``ShapeDtypeStruct`` stand-ins and reads XLA's analyses. The port runs the
same step eagerly on torch's ``meta`` device, where a tensor has a shape
and a dtype and no data, under ``launch/hlo_cost.py``'s ``CostMode``.
Nothing is allocated and no card is needed: running on ``meta`` is the
design, the counterpart of AOT compilation, not a fallback to the CPU.
The model is built on ``meta`` without drawing a weight
(``registry.build(cfg, device="meta")``), the counterpart of
``jax.eval_shape(bundle.init, ...)``.

Per cell this records, into
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``, the
reference's keys where the meaning is the same:

* ``memory``: ``argument_size_in_bytes``, the rank-0 shard
  (``parallel/sharding.py``'s ``_blocks``) of every leaf of the
  parameters, optimizer states, batch and cache, summed, as
  ``memory_analysis()`` prices the arguments; ``temp_size_in_bytes``, the
  peak of the traced step's live storages over ``n_devices`` (eager
  liveness, autograd's saved tensors included, not XLA's buffer
  assignment; the global peak beside it); ``peak_memory_in_bytes``, their
  sum;
* ``hlo_cost``: flops and the HBM proxy per rank. The port runs every
  tensor whole on one controller (``constrain`` returns ``x``,
  docs/port.md §parallel), so the step is traced at global shapes and
  divided by ``n_devices``; ``global`` holds the undivided figures;
* ``collectives``, per rank, from two sources kept apart.
  ``explicit``: what the port's step moves between ranks, reported by the
  code that moves it (``parallel/moe_ep.py``'s all-to-alls and FSDP
  gathers, the pipeline's hand-offs, ``compressed_psum``'s payloads),
  summed over the mesh and divided by ``n_devices``. ``from_specs``: what
  the reference's SPMD partitioner inserts and one controller never
  issues, priced from the specs: the gradient reduce-scatter over the dp
  axes (an all-reduce where the optimizer state is not dp-sharded), the
  ZeRO parameter all-gather, the per-layer FSDP weight gathers of heavy
  cells (twice a microbatch: the forward and the remat recompute), and one
  all-reduce per product whose weight shards the contracted dim over
  ``model``, recognised in the ``CostMode`` by the weight's storage, of
  the product's output over the dp ranks;
* ``trace_s``, which stands for the reference's ``lower_s`` and
  ``compile_s``.

No counterpart, so left out: the reference's raw ``cost`` (XLA's
``cost_analysis``, which counts a loop body once) and
``generated_code_size_in_bytes``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--resume]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.interop import Stacked, leaf_parts, param_tree
from repro_torch.launch.hlo_cost import Census, CostMode
from repro_torch.launch.mesh import (
    Mesh,
    dp_axes_for,
    make_production_mesh,
    mesh_axis_sizes,
)
from repro_torch.models import registry
from repro_torch.parallel.hints import with_hints
from repro_torch.parallel.sharding import (
    P,
    _axes,
    _blocks,
    build_cache_specs,
    build_param_specs,
)
from repro_torch.train.optimizer import AdamWConfig, init_state

# per-arch tuned microbatch counts (the reference's): kimi's FSDP weight
# gathers scale with the microbatch count, and its per-microbatch
# activations are small enough to halve it
TUNED_MICROBATCHES = {"kimi-k2-1t-a32b": 4}

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "experiments", "dryrun_torch",
)


def _np(axes, sizes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, tuple):
        n = 1
        for a in axes:
            n *= sizes[a]
        return n
    return sizes[axes]


def _pairs(tree, specs, path: str = ""):
    """(path, leaf, spec) of a value tree (dicts and lists of tensors or
    ``Stacked`` leaves) and its spec tree, in order; ``path`` joins the
    keys with ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), v, specs[k]) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v, s) for i, (v, s) in enumerate(
            zip(tree, specs, strict=True))]
    else:
        yield path, tree, specs
        return
    for k, v, s in items:
        yield from _pairs(v, s, f"{path}/{k}" if path else k)


def shard_shape(shape, spec, mesh, rank: int = 0) -> tuple:
    """Rank ``rank``'s piece of a ``shape`` under ``spec`` on ``mesh``
    (``NamedSharding(mesh, spec).shard_shape(shape)``)."""
    out = list(shape)
    for dim, _, size in _blocks(tuple(shape), spec, mesh, rank):
        out[dim] = size
    return tuple(out)


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def argument_bytes(trees, mesh) -> int:
    """Rank 0's bytes of every leaf of ``trees``, ``(tree, specs)``
    pairs."""
    return sum(_bytes(shard_shape(leaf.shape, spec, mesh), leaf.dtype)
               for tree, specs in trees
               for _, leaf, spec in _pairs(tree, specs))


_aten = torch.ops.aten
#: product -> ((operand index, its contracted dim), ...)
_PRODUCTS = {
    _aten.mm.default: ((0, 1), (1, 0)),
    _aten.addmm.default: ((1, 1), (2, 0)),
    _aten.bmm.default: ((0, 2), (1, 1)),
}


class _SpecMode(CostMode):
    """A :class:`CostMode` that also prices the all-reduce of every
    product whose weight shards the contracted dim over ``model``:
    ``weights`` maps a weight's storage to ``(sizes, strides, dims)``,
    ``dims`` its dims sharded over ``model``; the all-reduce moves the
    product's output over ``dp_size`` ranks."""

    def __init__(self, weights: dict, dp_size: int):
        super().__init__(fold=True)
        self.weights = weights
        self.dp_size = dp_size
        self.reduces = Census()

    def observe(self, func, args, kwargs, out) -> None:
        operands = _PRODUCTS.get(func)
        if operands is None or not self.weights:
            return
        for i, cdim in operands:
            x = args[i]
            w = self.weights.get(x.untyped_storage()._cdata)
            if w is None:
                continue
            sizes, strides, dims = w
            contracted = [d for d in range(len(sizes))
                          if strides[d] == x.stride(cdim)
                          and sizes[d] == x.shape[cdim]]
            if any(d in dims for d in contracted):
                n = out.numel() / self.dp_size
                self.reduces.add("all-reduce", self.mult,
                                 self.mult * n * out.element_size(),
                                 self.mult * n)
            return


def _model_sharded(params, pspecs, sizes) -> dict:
    """Each weight tensor whose spec shards a dim over ``model`` (of size
    above 1): storage -> (sizes, strides, those dims). A stacked leaf's
    spec drops its leading layer entry for each part."""
    if sizes.get("model", 1) < 2:
        return {}
    out = {}
    for _, leaf, spec in _pairs(params, pspecs):
        part_spec = tuple(spec)[1:] if isinstance(leaf, Stacked) else spec
        dims = {d for d, e in enumerate(part_spec) if "model" in _axes(e)}
        if not dims:
            continue
        for t in leaf_parts(leaf):
            out[t.untyped_storage()._cdata] = (tuple(t.shape), t.stride(),
                                               dims)
    return out


def _dp_names(spec) -> set:
    return {a for e in spec for a in _axes(e)} - {"model"}


def _spec_collectives(census, params, pspecs, opt_pspecs, mesh, *, mb: int,
                      grad_bytes: int, a2a: bool) -> None:
    """A train step's gradient sync, ZeRO all-gather and FSDP gathers, per
    rank, into ``census``. ``grad_bytes``: the gradient's bytes per
    element. ``a2a``: the MoE experts' FSDP gathers are the step's own
    (``moe_ep``'s, explicit)."""
    sizes = mesh_axis_sizes(mesh)
    dp_ranks = _np(tuple(a for a in sizes if a != "model"), sizes)
    opt = [spec for _, _, spec in _pairs(params, opt_pspecs)]
    for (path, leaf, pspec), ospec in zip(_pairs(params, pspecs), opt):
        nl = leaf.shape[0] if isinstance(leaf, Stacked) else 1
        n = math.prod(shard_shape(leaf.shape, pspec, mesh))
        p_dp, o_dp = _dp_names(pspec), _dp_names(ospec)
        if p_dp and _np(tuple(p_dp), sizes) > 1:
            # FSDP weight: gathered per layer for the forward and the
            # recompute of every microbatch, its gradient reduce-scattered
            if not (a2a and "moe/w_" in path):
                tp = P(*("model" if "model" in _axes(e) else None
                         for e in pspec))
                full = math.prod(shard_shape(leaf.shape, tp, mesh))
                census.add("all-gather", 2 * mb * nl,
                           2 * mb * full * leaf.dtype.itemsize, 2 * mb * full)
                census.add("reduce-scatter", mb * nl, mb * n * grad_bytes,
                           mb * n)
        elif o_dp - p_dp and _np(tuple(o_dp - p_dp), sizes) > 1:
            # ZeRO: the gradient reduce-scattered onto the optimizer
            # state's shard, the updated weight gathered back
            o = math.prod(shard_shape(leaf.shape, ospec, mesh))
            census.add("reduce-scatter", 1, o * grad_bytes, o)
            census.add("all-gather", 1, n * leaf.dtype.itemsize, n)
        elif dp_ranks > 1:
            census.add("all-reduce", 1, n * grad_bytes, n)


def build_cell(cfg, shape, mesh, *, num_microbatches: int = 8,
               fsdp: bool = True):
    """-> (fn, args, specs, info): ``fn(*args)`` is the cell's step on
    ``meta``; ``specs`` one spec tree per argument (a model's is its
    parameter tree's); ``info`` the model, the two parameter spec trees
    and the microbatch count (0 off training).

    Weight-sharding policy (the reference's): ZeRO-1 by default (params
    TP-sharded over 'model' only; optimizer states additionally sharded
    over the dp axes, costing one grad reduce-scatter + one param
    all-gather per step). Full FSDP (weights dp-sharded too, re-gathered
    per layer per microbatch) only when the per-model-shard weights
    exceed 6e9 bytes at train — kimi-k2's 1T params."""
    bundle = registry.build(cfg, device="meta")
    model = bundle.init()
    sizes = mesh_axis_sizes(mesh)
    dp = dp_axes_for(mesh, shape.global_batch)
    fsdp_axes = None
    if fsdp:
        fsdp_axes = ("pod", "data") if "pod" in sizes else ("data",)
    weights_per_shard = cfg.num_params() * 2 / sizes["model"]
    # only training carries optimizer states; inference weights stay
    # TP/EP-sharded, so decode and prefill never pay per-layer gathers
    heavy = weights_per_shard > 6e9 and shape.kind == "train"
    # inference cells of over-budget MoE archs: 2-D expert sharding
    expert_cols = ("data" if (cfg.moe and shape.kind != "train"
                              and weights_per_shard > 6e9) else None)
    params = param_tree(model)
    n_exp = cfg.moe.n_experts if cfg.moe else 0
    pspecs = build_param_specs(
        params, n_experts=n_exp, model_axis_size=sizes["model"],
        axis_sizes=sizes, fsdp_axes=fsdp_axes if heavy else None,
        expert_cols_axis=expert_cols)
    opt_pspecs = build_param_specs(
        params, n_experts=n_exp, model_axis_size=sizes["model"],
        axis_sizes=sizes, fsdp_axes=fsdp_axes)
    batch = registry.input_specs(cfg, shape)

    def batch_spec_for(k, v):
        if k == "pos":
            return P()
        if dp is not None and v.shape[0] % _np(dp, sizes) == 0:
            return P(dp)
        return P()

    bspecs = {k: batch_spec_for(k, v) for k, v in batch.items()}
    info = {"model": model, "pspecs": pspecs, "opt_pspecs": opt_pspecs,
            "num_microbatches": 0}
    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        opt = init_state(opt_cfg, params)
        mb = TUNED_MICROBATCHES.get(cfg.name, num_microbatches)
        if shape.global_batch % mb:
            mb = 1
        info["num_microbatches"] = mb
        step = bundle.make_train_step(opt_cfg, num_microbatches=mb,
                                      dp_axes=dp)
        ospecs = {"m": opt_pspecs, "v": opt_pspecs, "step": P()}
        return step, (model, opt, batch), (pspecs, ospecs, bspecs), info
    if shape.kind == "prefill":
        return (bundle.make_prefill_step(), (model, batch),
                (pspecs, bspecs), info)
    # decode: the cache of an audio model is a quarter of the frames long
    b = shape.global_batch
    s_cache = shape.seq_len if cfg.family != "audio" else shape.seq_len // 4
    cache = bundle.cache_init(b, s_cache)
    cspecs = build_cache_specs(cache, dp_axes=dp, n_kv_heads=cfg.n_kv_heads,
                               model_axis_size=sizes["model"],
                               axis_sizes=sizes)
    dec = bundle.make_decode_step()
    pos = s_cache // 2  # a position inside the cache; the spec prices it

    def decode(model, token, cache, _pos):
        return dec(model, token, cache, pos)

    return (decode, (model, batch["token"], cache, batch["pos"]),
            (pspecs, bspecs["token"], cspecs, P()), info)


def trace_cell(cfg, shape, mesh: Mesh, fn, args, specs, info, *,
               dp_size: int, hints: dict | None = None) -> dict:
    """Run ``fn(*args)`` (a cell of :func:`build_cell`, or one built alike)
    on ``meta`` under the :class:`_SpecMode` and ``hints``, and price it
    per rank of ``mesh``: the module docstring's figures but ``trace_s``
    and the arch/shape/mesh names. ``dp_size``: the ranks the batch
    splits over. ``hints["a2a"]`` set: the experts' FSDP gathers are the
    step's own (explicit)."""
    hints = hints or {}
    n_dev = mesh.size
    params = param_tree(info["model"])
    trees = [(params if isinstance(a, torch.nn.Module) else a, s)
             for a, s in zip(args, specs)]
    mode = _SpecMode(_model_sharded(params, info["pspecs"],
                                    mesh_axis_sizes(mesh)), dp_size)
    with mode:
        with_hints(fn, **hints)(*args)

    mb = info["num_microbatches"]
    from_specs = mode.reduces
    if shape.kind == "train":
        _spec_collectives(
            from_specs, params, info["pspecs"], info["opt_pspecs"], mesh,
            mb=max(mb, 1),
            grad_bytes=4 if mb > 1 else cfg.param_dtype.itemsize,
            a2a=hints.get("a2a") is not None)
    explicit = Census()
    for kind, c in mode.collectives.kinds.items():
        explicit.add(kind, c["count"], c["bytes"] / n_dev,
                     c["elems"] / n_dev)
    counts = {}
    for census in (explicit, from_specs):
        for kind, c in census.kinds.items():
            counts[kind] = counts.get(kind, 0) + c["count"]
    coll_elems = explicit.total("elems") + from_specs.total("elems")
    args_b = argument_bytes(trees, mesh)
    temp_b = mode.peak_bytes / n_dev
    return {
        "n_devices": n_dev,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "num_microbatches": mb,
        "memory": {
            "argument_size_in_bytes": int(args_b),
            "temp_size_in_bytes": int(temp_b),
            "peak_memory_in_bytes": int(args_b + temp_b),
            "temp_size_global_bytes": int(mode.peak_bytes),
        },
        "collectives": {"explicit": explicit.as_dict(),
                        "from_specs": from_specs.as_dict()},
        "hlo_cost": {
            "flops": mode.flops / n_dev,
            "coll_bytes": explicit.total("bytes") + from_specs.total("bytes"),
            "coll_elems": coll_elems,
            "coll_bytes_dtype": coll_elems * (
                2 if cfg.dtype == "bfloat16" else 4),
            "coll_counts": counts,
            "hbm_proxy_bytes": mode.hbm_proxy_bytes / n_dev,
            "n_whiles": mode.n_whiles,
            "global": {"flops": mode.flops,
                       "hbm_proxy_bytes": mode.hbm_proxy_bytes},
        },
        "model_params": cfg.num_params(),
        "active_params": cfg.active_params(),
    }


def dry_run(cfg, shape, mesh: Mesh, *, num_microbatches: int = 8,
            fsdp: bool = True, sp_enable: bool = False) -> dict:
    """:func:`build_cell` and :func:`trace_cell` under the reference's
    hints: expert parallelism over 'model', the batch over the dp axes,
    the all-to-all MoE dispatch for heavy-MoE training (kimi), sequence
    parallelism behind ``sp_enable``. ``trace_s`` times both."""
    sizes = mesh_axis_sizes(mesh)
    t0 = time.perf_counter()
    fn, args, specs, info = build_cell(
        cfg, shape, mesh, num_microbatches=num_microbatches, fsdp=fsdp)
    # sp='model' measured worse for attention archs in the reference;
    # sp=None unless asked for
    sp = ("model" if sp_enable and shape.kind in ("train", "prefill")
          and shape.seq_len % sizes["model"] == 0 else None)
    dp = dp_axes_for(mesh, shape.global_batch)
    ep_ok = cfg.moe and cfg.moe.n_experts % sizes["model"] == 0
    heavy = cfg.num_params() * 2 / sizes["model"] > 6e9
    use_a2a = bool(ep_ok and heavy and shape.kind == "train")
    fsdp_axes = ("pod", "data") if "pod" in sizes else ("data",)
    hints = dict(ep="model", ep_size=sizes["model"], dp=dp,
                 dp_size=_np(dp, sizes), sp=sp,
                 a2a=mesh if use_a2a else None,
                 fsdp=fsdp_axes if use_a2a else None)
    art = trace_cell(cfg, shape, mesh, fn, args, specs, info,
                     dp_size=_np(dp, sizes), hints=hints)
    return {**art, "fsdp": fsdp,
            "trace_s": round(time.perf_counter() - t0, 2)}


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             num_microbatches: int = 8, fsdp: bool = True,
             save: bool = True, sp_enable: bool = False) -> dict:
    cfg = ARCHS[arch_name]
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "skipped": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    art = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           **dry_run(cfg, shape, mesh, num_microbatches=num_microbatches,
                     fsdp=fsdp, sp_enable=sp_enable)}
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        path = os.path.join(
            ARTIFACT_DIR, f"{arch_name}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
    return art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact already exists")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="enable true sequence parallelism")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failures = []
    for a, s in cells:
        path = os.path.join(ARTIFACT_DIR, f"{a}__{s}__{mesh_name}.json")
        if args.resume and os.path.exists(path):
            print(f"[dryrun] skip (exists): {a} x {s} x {mesh_name}")
            continue
        print(f"[dryrun] {a} x {s} x {mesh_name} ...", flush=True)
        try:
            art = run_cell(a, s, multi_pod=args.multi_pod,
                           num_microbatches=args.microbatches,
                           fsdp=not args.no_fsdp, sp_enable=args.sp)
            if "skipped" in art:
                print(f"[dryrun]   SKIP: {art['skipped']}")
                continue
            mem = art["memory"]
            print(
                f"[dryrun]   ok: trace {art['trace_s']:.1f}s  "
                f"flops/dev {art['hlo_cost']['flops']:.3e}  "
                f"args/dev {mem['argument_size_in_bytes'] / 2**30:.2f} GiB  "
                f"temp/dev {mem['temp_size_in_bytes'] / 2**30:.2f} GiB  "
                f"coll/dev {art['hlo_cost']['coll_bytes'] / 2**30:.3f} GiB",
                flush=True)
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"[dryrun]   FAIL: {e}")
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        raise SystemExit(1)
    print("[dryrun] all cells traced")


if __name__ == "__main__":
    main()
