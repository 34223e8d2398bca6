"""Pipeline parallelism: the paper's *temporal cascade* in LM form (the
port of the JAX package's ``parallel/pipeline.py``).

``S`` stages (layer groups) live on the ``S`` ranks of a ``stage`` mesh
axis; ``M`` microbatches stream through. The schedule is the classic
GPipe-style fill/drain: utilization ``M / (M + S - 1)`` — the paper's
prologue/epilogue loss with m*d replaced by (S-1) stage-steps.

One controller walks the ``T = M + S - 1`` ticks. At tick ``t`` stage
``i`` runs microbatch ``t - i`` when there is one, the last stage retires
its output, and every other stage's output is copied to the next stage's
device for tick ``t + 1`` (the reference's ``ppermute``; a copy on the
same card when the stage mesh repeats a device). The reference computes
on zeros at the fill and drain ticks and never stores the result; here an
idle (stage, tick) launches nothing, and the output is the same
(docs/port.md §parallel). Each tick's hand-off bytes go to
``launch/hlo_cost.py``'s ``record_collective``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.launch.hlo_cost import record_collective


def pipeline_utilization(n_micro: int, n_stages: int) -> float:
    return n_micro / (n_micro + n_stages - 1)


def _stage_devices(mesh, stage_axis: str) -> list:
    """Stage ``i``'s device: the rank at stage ``i``, 0 on other axes."""
    base = {a: 0 for a in mesh.axis_names}
    return [mesh.devices[mesh.rank({**base, stage_axis: i})]
            for i in range(mesh.shape[stage_axis])]


def _stage_params(stage_params, i: int, dev):
    """Stage ``i``'s parameters: item ``i`` of a list (the groups of
    :func:`stack_stage_params` over modules), or slice ``i`` of every
    ``(S, ...)`` tensor of a dict tree, on ``dev``."""
    if isinstance(stage_params, (list, tuple)):
        return stage_params[i]
    if isinstance(stage_params, dict):
        return {k: _stage_params(v, i, dev) for k, v in stage_params.items()}
    return stage_params[i].to(dev)


def pipelined_forward(mesh, stage_fn: Callable, stage_axis: str = "stage"):
    """Build a pipelined forward: ``run(stage_params, micro) -> out``.

    ``stage_fn(stage_params_i, x) -> y`` of ``x``'s shape. ``stage_params``
    is :func:`stack_stage_params`'s result. ``micro`` is ``(M, mb, ...)``;
    ``out`` is ``(M, mb, ...)`` after all ``S`` stages, on the last
    stage's device. ``run.last`` holds the tick count, the stage calls
    made and the bytes handed off at each tick.
    """
    n_stages = mesh.shape[stage_axis]
    devs = _stage_devices(mesh, stage_axis)

    def run(stage_params, micro):
        params = [_stage_params(stage_params, i, devs[i])
                  for i in range(n_stages)]
        m = micro.shape[0]
        out = None
        inbox: dict = {}  # stage -> its input for this tick
        handoff, calls = [], 0
        for t in range(m + n_stages - 1):
            nxt, moved, elems = {}, 0, 0
            for i in range(n_stages):
                j = t - i
                if not 0 <= j < m:
                    continue  # fill or drain: this stage idles
                x = micro[j].to(devs[0]) if i == 0 else inbox.pop(i)
                y = stage_fn(params[i], x)
                calls += 1
                if i == n_stages - 1:
                    if out is None:
                        out = torch.empty((m,) + tuple(y.shape),
                                          dtype=y.dtype, device=devs[i])
                    out[j].copy_(y)
                else:
                    nxt[i + 1] = torch.empty_like(
                        y, device=devs[i + 1]).copy_(y)
                    moved += y.numel() * y.element_size()
                    elems += y.numel()
            inbox = nxt
            handoff.append(moved)
            if moved:  # the reference's ppermute of this tick
                record_collective("collective-permute", moved, elems)
        run.last = {"ticks": m + n_stages - 1, "stage_calls": calls,
                    "handoff_bytes": handoff}
        return out

    run.last = None
    return run


def stack_stage_params(per_layer_params, n_stages: int):
    """Regroup per-layer parameters into ``n_stages`` stages: every
    ``(L, ...)`` tensor of a dict tree (or a bare tensor) into an
    ``(S, L/S, ...)`` view, a list of ``L`` per-layer modules into ``S``
    lists. ``ValueError`` when ``L`` does not divide."""
    if isinstance(per_layer_params, (list, tuple, nn.ModuleList)):
        layers = list(per_layer_params)
        if len(layers) % n_stages:
            raise ValueError(f"layers {len(layers)} must divide stages "
                             f"{n_stages}")
        g = len(layers) // n_stages
        return [layers[i * g:(i + 1) * g] for i in range(n_stages)]
    if isinstance(per_layer_params, dict):
        return {k: stack_stage_params(v, n_stages)
                for k, v in per_layer_params.items()}
    a = per_layer_params
    l = a.shape[0]
    if l % n_stages:
        raise ValueError(f"layers {l} must divide stages {n_stages}")
    return a.reshape((n_stages, l // n_stages) + tuple(a.shape[1:]))
