"""Architecture registry: config -> (init, loss, forward, cache, decode)
bundle consumed by the launchers, the engine, the training loop and the
tests (the port of the JAX package's ``models/registry.py``, every
family), and the model inputs of a shape cell (:func:`input_specs`,
:func:`make_batch`).

The bundle is bound to one device at :func:`build`; its ``init`` draws the
weights from an explicit ``torch.Generator``. ``make_train_step`` trains
the model in place: the reference's ``jax.value_and_grad`` becomes
``torch.autograd.grad`` over the reference's parameter tree of the
module's own tensors (``interop.param_tree``), and microbatch gradients
accumulate in f32 buffers (docs/port.md §train). The xLSTM model (the
``"ssm"`` family) is assembled here from the blocks of ``models/xlstm.py``,
as in the reference (docs/port.md §ssm).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.interop import (
    Stacked,
    leaf_parts,
    param_tree,
    resolve_device,
)
from repro_torch.launch import hlo_cost

from . import transformer as tfm
from . import xlstm as xl
from . import zamba2 as zb
from .layers import _param, cross_entropy, normal_, rms_norm

# --------------------------------------------------------------------------
# xLSTM model assembly (heterogeneous block list)
# --------------------------------------------------------------------------


def _xlstm_pattern(cfg) -> tuple:
    if cfg.block_pattern:
        pat = list(cfg.block_pattern)
        if len(pat) < cfg.n_layers:  # tile the declared pattern
            pat = (pat * cfg.n_layers)[: cfg.n_layers]
        return tuple(pat)
    # default xLSTM[7:1]-style: one sLSTM every 6th block
    return tuple(
        "slstm" if (i % 6 == 5) else "mlstm" for i in range(cfg.n_layers)
    )


class XLSTM(nn.Module):
    """Embedding, the blocks of :func:`_xlstm_pattern` (an
    :class:`~repro_torch.models.xlstm.MLSTMBlock` or
    :class:`~repro_torch.models.xlstm.SLSTMBlock` each), final norm and
    head (``xlstm_init``)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.pattern = _xlstm_pattern(cfg)
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.blocks = nn.ModuleList(
            xl.MLSTMBlock(cfg, device=device) if kind == "mlstm"
            else xl.SLSTMBlock(cfg, device=device) for kind in self.pattern)
        self.ln_f = _param((cfg.d_model,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dt, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        normal_(self.embed, 0.02, generator)
        for block in self.blocks:
            block.init_weights(cfg, generator)
        self.ln_f.fill_(1.0)
        if hasattr(self, "lm_head"):
            normal_(self.lm_head, 1.0 / math.sqrt(cfg.d_model), generator)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def xlstm_init(cfg, generator: torch.Generator, device="cuda") -> XLSTM:
    model = XLSTM(cfg, device=resolve_device(device))
    model.init_weights(generator)
    return model


def xlstm_logits(model: XLSTM, tokens):
    """-> logits (B, S, vocab), with a graph when the parameters require
    grad (the loss path)."""
    cfg = model.cfg
    x = model.embed[tokens]
    for block, kind in zip(model.blocks, model.pattern):
        x = (xl.mlstm_block_apply(block, x, cfg) if kind == "mlstm"
             else xl.slstm_block_apply(block, x, cfg))
    x = rms_norm(x, model.ln_f)
    return x @ model.head()


@torch.no_grad()
def xlstm_forward(model: XLSTM, tokens):
    """:func:`xlstm_logits` without a graph: the serving forward."""
    return xlstm_logits(model, tokens)


def xlstm_cache_init(cfg, batch: int, seq: int, device="cuda") -> list:
    """One state dict per block, at the state-init values (mLSTM ``m`` at
    ``-inf``, sLSTM ``n`` at one); ``seq`` is unused (the state is
    O(1))."""
    dev = resolve_device(device)
    return [
        xl.mlstm_state_init(cfg, batch, dev) if k == "mlstm"
        else xl.slstm_state_init(cfg, batch, dev)
        for k in _xlstm_pattern(cfg)
    ]


@torch.no_grad()
def xlstm_decode(model: XLSTM, token, cache: list, pos: int, rows=None):
    """token: (B, 1) int; pos: int -> (logits (B, 1, V), cache).

    Writes every block's new state into ``cache`` in place: into every
    batch row (``rows=None``, the reference's step), or only into
    ``rows``. At ``pos`` 0 the stepped rows start from the state-init
    values (not zero: mLSTM ``m`` is ``-inf`` and sLSTM ``n`` one), since
    position 0 is a request's first token, whatever the slot held."""
    cfg = model.cfg
    x = model.embed[token]
    if rows is not None:  # one host-to-device copy per step, not per block
        rows = torch.as_tensor(rows, dtype=torch.int64, device=x.device)
    if pos == 0:
        for st, st0 in zip(cache, xlstm_cache_init(cfg, 1, 0, x.device)):
            for name, value in st0.items():
                if rows is None:
                    st[name].copy_(value.expand_as(st[name]))
                else:
                    st[name][rows] = value
    for block, st, kind in zip(model.blocks, cache, model.pattern):
        step = (xl.mlstm_block_decode if kind == "mlstm"
                else xl.slstm_block_decode)
        x, _ = step(block, x, cfg, st, rows)
    x = rms_norm(x, model.ln_f)
    return x @ model.head(), cache


# --------------------------------------------------------------------------
# Model bundle
# --------------------------------------------------------------------------


def _grads(loss, parts: list) -> list:
    """d loss / d each tensor of ``parts``; zeros for one the loss does not
    reach, as ``jax.grad`` gives."""
    gs = torch.autograd.grad(loss, parts, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(parts, gs)]


def _regroup(leaves: list, flat: list) -> list:
    """``flat`` (one tensor per part of each leaf) as one value per leaf:
    a :class:`~repro_torch.interop.Stacked` for a stacked leaf."""
    out, i = [], 0
    for leaf in leaves:
        n = len(leaf_parts(leaf))
        out.append(Stacked(flat[i:i + n]) if isinstance(leaf, Stacked)
                   else flat[i])
        i += n
    return out


@dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable  # generator -> model
    loss: Callable  # (model, batch) -> scalar, with a graph
    forward: Callable  # (model, batch) -> logits
    cache_init: Callable  # (batch, seq) -> cache
    # (model, token, cache, pos, rows=None) -> (logits, cache); an audio
    # bundle's fifth argument is enc_states
    decode: Callable

    # ---- step factories ---------------------------------------------------
    def make_train_step(self, opt_cfg, num_microbatches: int = 1,
                        dp_axes=None):
        """``train_step(model, opt_state, batch) -> (model, opt_state,
        metrics)``: the reference's step, on the model in place.

        The loss's gradient is taken over the reference's parameter tree
        of the module's own tensors (``interop.param_tree``), whose grad
        is turned on at the first step. ``num_microbatches > 1`` splits
        the batch's leading axis into that many consecutive blocks and
        sums their gradients in f32 buffers (the reference's
        ``g.astype(f32)``; bf16 ``.grad`` would sum in bf16), then
        divides loss and gradients by the count. ``batch`` may hold numpy
        arrays (the data pipeline's) or tensors.

        ``dp_axes`` names the mesh axes that carry the batch dim, where
        the reference pins each microbatch's dim 1 to them. One
        controller holds every microbatch whole, so it changes no value
        here (docs/port.md §parallel)."""
        from repro_torch.train.checkpoint import tree_flatten, tree_unflatten
        from repro_torch.train.optimizer import apply_updates

        dev = self.device

        def train_step(model, opt_state, batch):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            params = param_tree(model)
            leaves, treedef = tree_flatten(params)
            parts = [x for leaf in leaves for x in leaf_parts(leaf)]
            for p in parts:
                p.requires_grad_(True)
            if num_microbatches == 1:
                loss = self.loss(model, batch)
                flat = _grads(loss, parts)
                loss = loss.detach()
            else:
                nm = num_microbatches
                b = next(iter(batch.values())).shape[0]
                if b % nm:
                    raise ValueError(f"batch {b} % microbatches {nm}")
                bm = b // nm
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                       for p in parts]
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                # one microbatch costed nm times under the dry run's
                # folding CostMode (launch/hlo_cost.py), else all nm
                runs, region = hlo_cost.loop(nm)
                with region:
                    for i in range(runs):
                        mb = {k: v[i * bm:(i + 1) * bm]
                              for k, v in batch.items()}
                        li = self.loss(model, mb)
                        for a, g in zip(acc, _grads(li, parts)):
                            a.add_(g)
                        loss = loss + li.detach()
                loss = loss / nm
                flat = [a.div_(nm) for a in acc]
            grads = tree_unflatten(treedef, _regroup(leaves, flat))
            del flat
            _, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                  opt_state)
            metrics["loss"] = loss
            return model, opt_state, metrics

        return train_step

    def make_prefill_step(self):
        def prefill_step(model, batch):
            logits = self.forward(model, batch)
            return logits[:, -1]  # next-token logits

        return prefill_step

    def make_decode_step(self):
        def decode_step(model, token, cache, pos, rows=None):
            return self.decode(model, token, cache, pos, rows)

        return decode_step


def build(cfg: ArchConfig, *, device="cuda",
          use_kernel: bool | None = None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device``. ``use_kernel`` selects the
    attention of ``forward`` and ``loss`` (and of the encoder-decoder's
    cross-attention in ``decode``) as in ``ops.attention`` (``None``: the
    flash kernel on a CUDA device, the chunked version on the CPU). An
    ``"audio"`` bundle's ``decode`` takes ``enc_states`` where the others
    take ``rows``; the serving engine refuses it (docs/port.md §encdec).
    ``ValueError`` for an unknown family, as the reference raises. On
    ``"meta"`` the bundle's ``init`` builds the module and draws nothing
    (its generator is ignored): the dry run's shapes
    (docs/port.md §dryrun)."""
    dev = resolve_device(device)
    bundle = _build(cfg, dev, use_kernel)
    if dev.type == "meta":
        # shapes only, the counterpart of jax.eval_shape(bundle.init, ...):
        # the module's parameters are meta tensors and nothing is drawn
        cls = {"hybrid": zb.Zamba2, "ssm": XLSTM}.get(cfg.family,
                                                      tfm.Transformer)
        bundle.init = lambda generator=None: cls(cfg, device=dev)
    return bundle


def _build(cfg: ArchConfig, dev: torch.device, use_kernel) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        def fwd(model, batch):
            return tfm.forward(model, batch["tokens"], batch.get("embeds"),
                               use_kernel=use_kernel)

        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: tfm.init_params(cfg, generator, dev),
            loss=lambda model, batch: tfm.lm_loss(model, batch,
                                                  use_kernel=use_kernel),
            forward=fwd,
            cache_init=lambda b, s: tfm.init_cache(cfg, b, s, dev),
            decode=lambda model, tok, cache, pos, rows=None: tfm.decode_step(
                model, tok, cache, pos, rows),
        )
    if fam == "audio":
        # self-cache of length s; cross K/V cache over 4 * s encoder frames
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: tfm.init_params(cfg, generator, dev),
            loss=lambda model, batch: tfm.lm_loss(model, batch,
                                                  use_kernel=use_kernel),
            forward=lambda model, batch: tfm.forward_enc_dec(
                model, batch["frames"], batch["tokens"],
                use_kernel=use_kernel),
            cache_init=lambda b, s: tfm.init_cache(cfg, b, s, dev,
                                                   enc_len=4 * s),
            decode=lambda model, tok, cache, pos, enc_states=None:
                tfm.decode_step_enc_dec(model, tok, cache, pos, enc_states,
                                        use_kernel=use_kernel),
        )
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: zb.init_params(cfg, generator, dev),
            loss=lambda model, batch: cross_entropy(
                zb.logits(model, batch["tokens"], use_kernel=use_kernel),
                batch["labels"]),
            forward=lambda model, batch: zb.forward(
                model, batch["tokens"], use_kernel=use_kernel),
            cache_init=lambda b, s: zb.init_cache(cfg, b, s, dev),
            decode=lambda model, tok, cache, pos, rows=None: zb.decode_step(
                model, tok, cache, pos, rows),
        )
    if fam == "ssm":
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: xlstm_init(cfg, generator, dev),
            loss=lambda model, batch: cross_entropy(
                xlstm_logits(model, batch["tokens"]), batch["labels"]),
            forward=lambda model, batch: xlstm_forward(model,
                                                       batch["tokens"]),
            cache_init=lambda b, s: xlstm_cache_init(cfg, b, s, dev),
            decode=lambda model, tok, cache, pos, rows=None: xlstm_decode(
                model, tok, cache, pos, rows),
        )
    raise ValueError(f"unknown family {fam!r}")


# --------------------------------------------------------------------------
# Input specs (meta tensors) and seeded batches
# --------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    """A stand-in of one model input: a tensor on the meta device, which
    holds a shape and a dtype and no data (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The inputs of every model call of this cell, as meta tensors, in
    the reference's key order: audio ``frames (B, S, d)`` and ``S / 4``
    tokens; VLM ``embeds (B, n_frontend_tokens, d)`` and the remaining
    tokens; ``labels`` beside the tokens at train; at decode one
    ``token`` and ``pos`` (an audio model's cross K/V lives in the cache,
    primed once)."""
    b, s = shape.global_batch, shape.seq_len
    dt, tok = cfg.param_dtype, torch.int32
    if shape.kind == "decode":
        return {"token": _spec((b, 1), tok), "pos": _spec((), tok)}
    if cfg.family == "audio":
        out = {"frames": _spec((b, s, cfg.d_model), dt),
               "tokens": _spec((b, s // 4), tok)}
    elif cfg.family == "vlm":
        nf = cfg.n_frontend_tokens
        out = {"embeds": _spec((b, nf, cfg.d_model), dt),
               "tokens": _spec((b, s - nf), tok)}
    else:
        out = {"tokens": _spec((b, s), tok)}
    if shape.kind == "train":
        out["labels"] = _spec(out["tokens"].shape, tok)
    return out


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> dict:
    """A concrete batch of :func:`input_specs` on ``device``: integers in
    ``[0, vocab)`` and standard normals (drawn in f32, then cast), from
    ``np.random.default_rng(seed)`` in the specs' order, so that it equals
    the reference's batch of the same seed; ``pos`` is ``seq_len // 2``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "pos":
            x = torch.tensor(shape.seq_len // 2, dtype=v.dtype)
        elif v.dtype == torch.int32:
            x = torch.from_numpy(rng.integers(0, cfg.vocab, v.shape).astype(
                np.int32))
        else:
            x = torch.from_numpy(rng.standard_normal(v.shape).astype(
                np.float32)).to(v.dtype)
        out[k] = x.to(dev)
    return out
