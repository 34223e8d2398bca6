"""Gradient compression for the data-parallel all-reduce (the port of the
JAX package's ``parallel/compression.py``).

Two schemes, both with error feedback (the residual re-enters the next
step, so compression error accumulates to zero over time):

* int8 uniform quantization with per-tensor scale — 4x traffic cut on the
  slow hop, negligible quality loss with EF.
* top-k magnitude sparsification — k fraction of entries + indices.

:func:`compressed_psum` is the counterpart of the reference's
``shard_map`` body with ``lax.psum``: it takes one gradient tree per rank
of the data axis, moves each rank's payload to rank 0's device (a copy
between cards; on one card the reduction reads each rank's buffer), sums
it there in rank order and divides by the count. Each leaf's payloads,
summed over the ranks, go to ``launch/hlo_cost.py``'s
``record_collective``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.launch.hlo_cost import record_collective
from repro_torch.train.checkpoint import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8_ef"  # 'int8_ef' | 'topk_ef' | 'none'
    topk_frac: float = 0.01


def init_residuals(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_int8(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(g, r):
    """-> (payload, deq, new_residual). deq is this worker's contribution
    as the receivers will see it."""
    x = g.float() + r
    q, scale = _quant_int8(x)
    deq = q.float() * scale
    return (q, scale), deq, x - deq


def compress_topk(g, r, frac: float):
    x = (g.float() + r).reshape(-1)
    k = max(1, int(frac * x.numel()))
    _, idx = torch.topk(x.abs(), k)
    vals = x[idx]
    deq = torch.zeros_like(x).index_copy_(0, idx, vals)
    return (vals, idx), deq.view(g.shape), (x - deq).view(g.shape)


def compressed_psum(rank_grads: list, rank_residuals: list,
                    cfg: CompressionConfig = CompressionConfig()):
    """All-reduce (mean) with compression + error feedback over the ranks
    of one data axis: ``rank_grads[i]`` and ``rank_residuals[i]`` are rank
    ``i``'s trees. Returns ``(mean_grads, new_residuals)``: one mean tree
    on rank 0's device and one residual tree per rank, on its device.

    The sum runs in f32 from zero in rank order (``0 + c0 + c1 + ...``),
    then divides by the count. ``int8_ef`` moves each rank's int8 payload
    and scale and dequantizes at the receiver; the sum of ``q · scale`` is
    the reference's ``psum(q.astype(f32) * scale)``."""
    n = len(rank_grads)
    flat_g = [tree_flatten(t)[0] for t in rank_grads]
    flat_r = [tree_flatten(t)[0] for t in rank_residuals]
    treedef = tree_flatten(rank_grads[0])[1]
    means, new_res = [], [[] for _ in range(n)]
    for j in range(len(flat_g[0])):
        dev = flat_g[0][j].device
        total = torch.zeros(flat_g[0][j].shape, dtype=torch.float32,
                            device=dev)
        wire = [0, 0]  # the payloads' bytes and elements, all ranks
        for i in range(n):
            g, r = flat_g[i][j], flat_r[i][j]
            if cfg.scheme == "none":
                total.add_(g.to(dev).float())
                new_res[i].append(r)
                payload = (g,)
            elif cfg.scheme == "int8_ef":
                (q, scale), _, nr = compress_int8(g, r)
                # wire payload is (int8 q, f32 scale)
                total.add_(q.to(dev).float() * scale.to(dev))
                new_res[i].append(nr)
                payload = (q, scale)
            elif cfg.scheme == "topk_ef":
                payload, deq, nr = compress_topk(g, r, cfg.topk_frac)
                total.add_(deq.to(dev))
                new_res[i].append(nr)
            else:
                raise ValueError(cfg.scheme)
            for x in payload:
                wire[0] += x.numel() * x.element_size()
                wire[1] += x.numel()
        record_collective("all-reduce", *wire)
        means.append(total / n)
    return (tree_unflatten(treedef, means),
            [tree_unflatten(treedef, res) for res in new_res])


def payload_bytes(params: Any, cfg: CompressionConfig) -> int:
    """Analytic wire-bytes per step (feeds the roofline collective term)."""
    leaves = tree_flatten(params)[0]
    n = sum(math.prod(leaf.shape) for leaf in leaves)
    if cfg.scheme == "int8_ef":
        return n + 4 * len(leaves)
    if cfg.scheme == "topk_ef":
        k = int(cfg.topk_frac * n)
        return 8 * k  # f32 value + i32 index
    return 2 * n  # bf16 baseline
