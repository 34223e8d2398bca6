"""AdamW with a configurable state dtype (f32 by default; bf16 quantises
the moments when they are stored), a cosine LR schedule and global-norm
clipping (the port of the JAX package's ``train/optimizer.py``): plain
functions on trees of tensors, no ``torch.optim``.

The state is ``{"m", "v", "step"}``, ``m`` and ``v`` trees of the
parameter tree's structure and ``step`` an int32 scalar, laid out as the
reference's, so a checkpoint of ``{"params", "opt"}`` cross-reads
(docs/port.md §train). :func:`apply_updates` updates the parameters and
the moments in place and returns them. A leaf may be an
``interop.Stacked`` (one stacked leaf of the reference's tree, held as
per-layer tensors): its moments are one ``(L, ...)`` tensor each, and its
decay follows the stacked ``ndim``, as in the reference; the selection
bias of sigmoid routing never decays (:data:`NO_DECAY`).

On CUDA parameters the norm and the update run as the fused pass of
``kernels/adamw`` (``csrc/adamw.cu``): each state word read and written
once, ``p``, ``m`` and ``v`` bitwise what :func:`_update` gives for the
same clip scale, the norm summed in another fixed order. Elsewhere (the
CPU, the dry run's ``meta``) :func:`_global_norm` and :func:`_update` run
as plain torch, one kernel an op (docs/port.md §train).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.interop import Stacked, leaf_parts
from repro_torch.kernels.adamw.adamw import AdamWPart, adamw_step, adamw_sumsq
from repro_torch.train.checkpoint import tree_flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or a tensor; a tensor keeps
    the result on its device): linear warmup, then cosine to
    ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(cfg: AdamWConfig, params) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    leaves, _ = tree_flatten(params)

    def zeros(p):
        return torch.zeros(tuple(p.shape), dtype=dt, device=p.device)

    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None),
    }


def _global_norm(tree):
    parts = [p for leaf in tree_flatten(tree)[0] for p in leaf_parts(leaf)]
    return torch.sqrt(sum(torch.sum(torch.square(p.float())) for p in parts))


def _update(cfg, p, g, m, v, lr, scale, bc1, bc2, decay: bool) -> None:
    """One tensor's step in f32, written back in place (``p`` in its
    dtype, the moments in theirs)."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float() * scale
    mf = b1 * m.float() + (1 - b1) * gf
    vf = b2 * v.float() + (1 - b2) * gf * gf
    del gf
    delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
    m.copy_(mf)
    v.copy_(vf)
    del mf, vf
    if decay:  # decoupled weight decay on matrices only
        delta = delta + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)


def _names(tree, prefix: str = ""):
    """A tree of ``tree``'s structure whose leaves are their dotted
    paths."""
    if isinstance(tree, dict):
        return type(tree)((k, _names(v, f"{prefix}{k}."))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        names = [_names(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return (type(tree)(*names) if hasattr(tree, "_fields")
                else type(tree)(names))
    return None if tree is None else prefix[:-1]


#: Leaves (by the last part of their dotted name) that weight decay never
#: moves: the router's selection bias of sigmoid routing, which chooses
#: the experts and gets no gradient (``models/layers.py`` ``moe_router``),
#: so that it keeps its drawn value.
NO_DECAY = ("select_bias",)


def decays(name: str, ndim: int) -> bool:
    """Whether the leaf ``name`` of ``ndim`` dimensions (a stacked leaf's
    ``ndim``) takes the decoupled weight decay: matrices only, and none
    of :data:`NO_DECAY`."""
    return ndim >= 2 and name.rsplit(".", 1)[-1] not in NO_DECAY


def _parts(params, grads, state) -> list[AdamWPart]:
    """The update's tensors in the tree's leaf order, a ``Stacked`` leaf
    one part a layer (named ``leaf[i]``); a leaf decays by its own
    ``ndim`` (:func:`decays`)."""
    flat = zip(*(tree_flatten(t)[0] for t in
                 (_names(params), params, grads, state["m"], state["v"])))
    out = []
    for name, p, g, m, v in flat:
        decay = decays(name, p.ndim)
        gs = leaf_parts(g)
        for i, part in enumerate(leaf_parts(p)):
            if isinstance(p, Stacked):
                out.append(AdamWPart(f"{name}[{i}]", part, gs[i], m[i], v[i],
                                     decay))
            else:
                out.append(AdamWPart(name, part, gs[i], m, v, decay))
    return out


def _plain_pass(cfg, parts, lr, bc1, bc2):
    """The plain version of the fused pass: the global norm of the parts'
    gradients, the clip scale, then :func:`_update` of every part; ->
    the norm."""
    gnorm = _global_norm([part.g for part in parts])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    for part in parts:
        _update(cfg, part.p, part.g, part.m, part.v, lr, scale, bc1, bc2,
                part.decay)
    return gnorm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """-> (params, new_state, metrics), ``params`` and the moments updated
    in place. Update math runs in f32 even when the moments are stored
    bf16 (quantize on store)."""
    step = state["step"] + 1
    lr = lr_at(cfg, state["step"])
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    parts = _parts(params, grads, state)
    if parts and parts[0].p.device.type == "cuda":
        gnorm, scale = adamw_sumsq(parts, cfg.clip_norm)
        adamw_step(parts, lr, scale, bc1, bc2, b1=cfg.b1, b2=cfg.b2,
                   eps=cfg.eps, weight_decay=cfg.weight_decay)
    else:
        gnorm = _plain_pass(cfg, parts, lr, bc1, bc2)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
