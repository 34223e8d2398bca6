"""Architecture registry: config -> (init, forward, cache, decode) bundle
consumed by the serving launcher, the engine and the tests (the port of
the JAX package's ``models/registry.py``, families ``"dense"``, ``"moe"``,
``"vlm"``, ``"audio"`` and ``"hybrid"``), and the model inputs of a shape
cell (:func:`input_specs`, :func:`make_batch`).

The bundle is bound to one device at :func:`build`; its ``init`` draws the
weights from an explicit ``torch.Generator``. Training (``loss``,
``make_train_step``, ROADMAP Queue 1, item 6) and the ``"ssm"`` family
(item 5) wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.interop import resolve_device

from . import transformer as tfm
from . import zamba2 as zb


@dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init: Callable  # generator -> model
    forward: Callable  # (model, batch) -> logits
    cache_init: Callable  # (batch, seq) -> cache
    # (model, token, cache, pos, rows=None) -> (logits, cache); an audio
    # bundle's fifth argument is enc_states
    decode: Callable

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
    attention of ``forward`` (and of the encoder-decoder's cross-attention
    in ``decode``) as in ``ops.attention`` (``None``: the flash kernel on
    a CUDA device, the chunked version on the CPU). An ``"audio"``
    bundle's ``decode`` takes ``enc_states`` where the others take
    ``rows``; the serving engine refuses it (docs/port.md §encdec)."""
    if cfg.family not in ("dense", "moe", "vlm", "audio", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            "port serves the dense, moe, vlm, audio and hybrid families "
            "(ROADMAP Queue 1: ssm item 5)"
        )
    dev = resolve_device(device)
    if cfg.family == "audio":
        # self-cache of length s; cross K/V cache over 4 * s encoder frames
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: tfm.init_params(cfg, generator, dev),
            forward=lambda model, batch: tfm.forward_enc_dec(
                model, batch["frames"], batch["tokens"],
                use_kernel=use_kernel),
            cache_init=lambda b, s: tfm.init_cache(cfg, b, s, dev,
                                                   enc_len=4 * s),
            decode=lambda model, tok, cache, pos, enc_states=None:
                tfm.decode_step_enc_dec(model, tok, cache, pos, enc_states,
                                        use_kernel=use_kernel),
        )
    if cfg.family == "hybrid":
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init=lambda generator: zb.init_params(cfg, generator, dev),
            forward=lambda model, batch: zb.forward(
                model, batch["tokens"], use_kernel=use_kernel),
            cache_init=lambda b, s: zb.init_cache(cfg, b, s, dev),
            decode=lambda model, tok, cache, pos, rows=None: zb.decode_step(
                model, tok, cache, pos, rows),
        )

    def fwd(model, batch):
        return tfm.forward(model, batch["tokens"], batch.get("embeds"),
                           use_kernel=use_kernel)

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init=lambda generator: tfm.init_params(cfg, generator, dev),
        forward=fwd,
        cache_init=lambda b, s: tfm.init_cache(cfg, b, s, dev),
        decode=lambda model, tok, cache, pos, rows=None: tfm.decode_step(
            model, tok, cache, pos, rows),
    )


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
