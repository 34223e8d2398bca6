"""Logical-axis sharding rules: parameter/activation partition specs, and
the split of a tensor into the per-rank pieces of a spec (the port of the
JAX package's ``parallel/sharding.py``).

One rule table serves every architecture. Rules match on the *leaf path*
(joined dict keys) and leaf rank; stacked per-layer leaves (leading L axis)
get a ``None`` prepended automatically. Tensor-parallel placements follow
Megatron conventions: column-parallel up-projections, row-parallel
down-projections, vocab-sharded embeddings, expert-sharded MoE.

The trees walked are the reference's: ``interop.param_tree(model)``, whose
keys are the reference's and whose ``Stacked`` leaves have the stacked
``(L, ...)`` shape, and a model's cache. :func:`shard` and
:func:`unshard` place a tensor on a logical mesh (``launch/mesh.py``): a
rank's piece is a view of the tensor on the tensor's own device, so a
mesh that repeats one device holds no copy of its weights
(docs/port.md §parallel).
"""

from __future__ import annotations

import re
from typing import Any

import torch


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor, each
    ``None`` (whole), a mesh axis name, or a tuple of names (the dim split
    over their product, the first name major). Missing trailing entries
    are ``None``. The counterpart of ``jax.sharding.PartitionSpec``, which
    it normalizes as JAX does: a one-name tuple is that name, an empty one
    ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# (regex on path, spec for the *trailing* dims of the leaf)
# Order matters: first match wins.
_RULES: list[tuple[str, tuple]] = [
    (r"moe/router$", (None, None)),
    # MoE expert stacks (E, d, f) / (E, f, d): expert-parallel over 'model'
    # when E divides the axis, else fall back to TP within the expert.
    (r"moe/w_(gate|up)$", ("__expert__", None, "__expert_tp_col__")),
    (r"moe/w_down$", ("__expert__", "__expert_tp_row__", None)),
    # embed: d-sharded (token gather stays local; vocab-sharding forces the
    # partitioner into involuntary full rematerialization of the gather)
    (r"(embed)$", (None, "model")),
    (r"lm_head$", (None, "model")),
    # column-parallel in-projections
    (r"(wq|wv|wk|w_gate|w_up|w_in|in_proj|w_zifo|w_if)$", (None, "model")),
    # row-parallel out-projections
    (r"(wo|w_down|out_proj|w_out)$", ("model", None)),
    (r"(bq|bk|bv)$", ("model",)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"r_zifo$", (None, None, None)),
    # everything 1-D (norm scales, A_log, D, dt_bias): replicated
    (r".*", None),
]


def _axis_size(axis, axis_sizes: dict) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(axis, 1)


def param_pspec(path: str, leaf, *, n_experts: int = 0,
                model_axis_size: int = 1, axis_sizes: dict | None = None,
                fsdp_axes=None, expert_cols_axis=None) -> P:
    """Resolve one leaf's spec; ``path`` is its keys joined by ``/``.

    ``fsdp_axes`` (e.g. ``('pod', 'data')``): ZeRO-3-style weight sharding —
    placed on the first still-unsharded dim of every >=2-D weight leaf.
    Every placement is divisibility-checked against ``axis_sizes`` and
    dropped (replicated) when the dim does not divide, so odd vocabularies
    (whisper's 51865) degrade gracefully.
    """
    axis_sizes = axis_sizes or {"model": model_axis_size}
    ps = path
    rank = len(leaf.shape)
    for pat, spec in _RULES:
        if not re.search(pat, ps):
            continue
        if spec is None:
            spec = ()
        spec = list(spec)
        ep_ok = n_experts and (n_experts % _axis_size("model", axis_sizes) == 0)
        for i, s in enumerate(spec):
            if s == "__expert__":
                spec[i] = "model" if ep_ok else None
            elif s in ("__expert_tp_col__", "__expert_tp_row__"):
                if ep_ok:
                    # inference 2-D expert sharding: FFN dim over a second
                    # axis keeps weights resident (no per-layer d-gathers);
                    # the f-contraction pays one small activation AR instead
                    spec[i] = expert_cols_axis
                else:
                    spec[i] = "model"
        extra = rank - len(spec)
        if extra < 0:
            return P()
        spec = [None] * extra + spec
        # divisibility check for the base (tensor-parallel) placement
        for i, s in enumerate(spec):
            if s is not None and leaf.shape[i] % _axis_size(s, axis_sizes):
                spec[i] = None
        # FSDP: shard the first free dim of substantial weight leaves.
        # The embedding table is excluded: its gather needs the vocab dim
        # whole, and FSDP on d would leave the lookup output oddly sharded.
        if fsdp_axes and rank >= 2 and ps and not re.search(
                r"(router|embed)$", ps):
            n_fsdp = _axis_size(tuple(fsdp_axes), axis_sizes)
            # skip the scan-stack axis (dim 0 of stacked layers): start at
            # the first dim belonging to the weight itself
            start = extra
            for i in range(start, rank):
                if spec[i] is None and leaf.shape[i] % n_fsdp == 0 \
                        and leaf.shape[i] >= 2 * n_fsdp:
                    spec[i] = tuple(fsdp_axes)
                    break
        return P(*spec)
    return P()


def _map_with_path(fn, tree, path=()):
    """``tree`` (nested dicts and lists) with each leaf ``x`` replaced by
    ``fn("k1/k2/...", x)``, as ``jax.tree_util.tree_map_with_path``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def build_param_specs(params_shape: Any, *, n_experts: int = 0,
                      model_axis_size: int = 1, axis_sizes: dict | None = None,
                      fsdp_axes=None, expert_cols_axis=None):
    """Map a parameter tree (``interop.param_tree(model)``, or any nested
    dicts and lists of leaves with a ``shape``) to a tree of specs."""
    return _map_with_path(
        lambda path, leaf: param_pspec(
            path, leaf, n_experts=n_experts, model_axis_size=model_axis_size,
            axis_sizes=axis_sizes, fsdp_axes=fsdp_axes,
            expert_cols_axis=expert_cols_axis,
        ),
        params_shape,
    )


def batch_pspec(dp_axes) -> P:
    return P(dp_axes, None)


def stream_grid_pspec(axis: str = "d", axis_x: str | None = None) -> P:
    """(P, H, W) stream-grid sharding: rows (y) split across ``axis``.

    The channel dim stays whole (every shard needs all P fields of its
    rows) and rows shard contiguously so each device owns one H/d-row
    band — the decomposition ``core/distribute.py`` halo-exchanges.
    ``axis_x`` additionally splits the columns (x) for the 2-D device
    mesh: each device then owns one contiguous ``(H/dy, W/dx)`` tile.
    """
    return P(None, axis, axis_x)


def cache_pspec(path: str, leaf, *, dp_axes, n_kv_heads: int,
                model_axis_size: int, axis_sizes: dict | None = None) -> P:
    """KV/SSM cache shardings: batch over dp, heads over 'model' when they
    divide. batch==1 (long-context decode): the sequence dim takes the dp
    axes instead, so a 500k-token cache spreads across the fleet."""
    axis_sizes = axis_sizes or {"model": model_axis_size}
    ps = path
    rank = len(leaf.shape)

    def fits(dim_size, axis):
        return axis is not None and dim_size % _axis_size(axis, axis_sizes) == 0

    if re.search(r"(^|/)(k|v|xk|xv)$", ps) and rank >= 4:
        b, hkv, s, hd = leaf.shape[-4:]
        if fits(hkv, "model"):
            kv_model, kv_seq = "model", None
        else:
            # MQA/GQA heads don't divide the TP axis: seq-shard the cache
            # instead (flash-decoding layout, see layers._kv_decode_spec)
            kv_model = None
            kv_seq = "model" if fits(s, "model") else None
        if fits(b, dp_axes):
            spec = [dp_axes, kv_model, kv_seq, None]
        elif fits(s, dp_axes):
            spec = [None, kv_model, dp_axes, None]
        else:
            spec = [None, kv_model, kv_seq, None]
        return P(*([None] * (rank - 4) + spec))
    if re.search(r"ssm/h$", ps) and rank >= 4:
        b, h = leaf.shape[-4:-2]
        spec = [
            dp_axes if fits(b, dp_axes) else None,
            "model" if fits(h, "model") else None,
            None, None,
        ]
        return P(*([None] * (rank - 4) + spec))
    if re.search(r"ssm/conv$", ps) and rank >= 3:
        b, _, c = leaf.shape[-3:]
        spec = [
            dp_axes if fits(b, dp_axes) else None,
            None,
            "model" if fits(c, "model") else None,
        ]
        return P(*([None] * (rank - 3) + spec))
    # generic state leaves: batch-shard dim 0 when possible
    if rank >= 1 and fits(leaf.shape[0], dp_axes):
        return P(*([dp_axes] + [None] * (rank - 1)))
    return P()


def build_cache_specs(cache_shape: Any, *, dp_axes, n_kv_heads: int,
                      model_axis_size: int, axis_sizes: dict | None = None):
    return _map_with_path(
        lambda path, leaf: cache_pspec(
            path, leaf, dp_axes=dp_axes, n_kv_heads=n_kv_heads,
            model_axis_size=model_axis_size, axis_sizes=axis_sizes,
        ),
        cache_shape,
    )


# --------------------------------------------------------------------------
# Placement on a logical mesh
# --------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _blocks(shape, spec, mesh, rank: int) -> list:
    """(dim, start, size) of rank ``rank``'s piece on each split dim."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than dims {shape}")
    coords = mesh.coords(rank)
    out = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + coords[a]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways ({entry})")
        size = shape[dim] // n
        out.append((dim, i * size, size))
    return out


def shard(x: torch.Tensor, spec, mesh) -> list:
    """The per-rank pieces of ``x`` under ``spec``, one per rank of
    ``mesh`` in rank order. A piece on ``x``'s own device is a view
    (``narrow``) and shares ``x``'s storage; one on another device is a
    copy there."""
    out = []
    for r in range(mesh.size):
        piece = x
        for dim, start, size in _blocks(x.shape, spec, mesh, r):
            piece = piece.narrow(dim, start, size)
        dev = mesh.devices[r]
        out.append(piece if piece.device == dev else piece.to(dev))
    return out


def unshard(shards: list, spec, mesh) -> torch.Tensor:
    """The whole tensor of per-rank pieces under ``spec``, on rank 0's
    device: each distinct piece (the ranks at coordinate 0 on every axis
    ``spec`` does not name) copied into place, bitwise."""
    named = {a for e in spec for a in _axes(e)}
    shape = list(shards[0].shape)
    for dim, e in enumerate(spec):
        shape[dim] *= _axis_size(_axes(e), mesh.shape)
    out = torch.empty(shape, dtype=shards[0].dtype, device=mesh.devices[0])
    for r, piece in enumerate(shards):
        if any(c for a, c in mesh.coords(r).items() if a not in named):
            continue
        view = out
        for dim, start, size in _blocks(shape, spec, mesh, r):
            view = view.narrow(dim, start, size)
        view.copy_(piece)
    return out

