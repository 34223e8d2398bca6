"""Architecture registry: config -> (init, forward, cache, decode) bundle
consumed by the serving launcher, the engine and the tests (the port of
the JAX package's ``models/registry.py``, families ``"dense"``, ``"moe"``
and ``"hybrid"``).

The bundle is bound to one device at :func:`build`; its ``init`` draws the
weights from an explicit ``torch.Generator``. Training (``loss``,
``make_train_step``, ROADMAP Queue 1, item 6) and the other families
(``"audio"``: item 3; ``"vlm"``: item 4; ``"ssm"``: item 5) wait for
later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
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
    decode: Callable  # (model, token, cache, pos, rows=None) -> (logits, cache)

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
    attention of ``forward`` as in ``ops.attention`` (``None``: the flash
    kernel on a CUDA device, the chunked version on the CPU)."""
    if cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            "port serves the dense, moe and hybrid families (ROADMAP "
            "Queue 1: audio item 3, vlm item 4, ssm item 5)"
        )
    dev = resolve_device(device)
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
