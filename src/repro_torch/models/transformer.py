"""Decoder-only transformer LM, dense and MoE (the port of the JAX
package's ``models/transformer.py``).

Entry points:
  Transformer(cfg, device=...)                 the parameters, nn.Modules
  init_params(cfg, generator, device)          -> Transformer, seeded init
  forward(model, tokens, embeds, positions)    -> logits     (prefill)
  init_cache(cfg, batch, seq, device)          -> cache
  decode_step(model, token, cache, pos, rows)  -> (logits, cache)

The JAX package scans a stacked ``L`` axis under remat; here the layers
are an ``nn.ModuleList`` walked by a Python loop, and no gradient is kept.
The KV cache is a preallocated ``(L, B, Hkv, S, D)`` pair updated in place
(docs/port.md §lm); ``decode_step`` returns the same tensors so that its
signature stays the reference's. An MoE config's first
``moe_start_layer`` layers are dense and the rest MoE (the reference's
``layers`` and ``moe_layers`` groups, in that order in the cache;
docs/port.md §moe). The encoder-decoder path and the VLM frontend's
inputs wait for later slices (ROADMAP Queue 1, items 3 and 4).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.interop import resolve_device

from .layers import (
    MLP,
    Attention,
    MoE,
    _param,
    attention_block,
    decode_attention,
    mlp_apply,
    moe_apply,
    normal_,
    rms_norm,
)


class DecoderLayer(nn.Module):
    """Pre-norm attention + MLP block, or + MoE block with ``moe=True``
    (``_init_layer`` / ``_layer_apply``)."""

    def __init__(self, cfg, *, moe: bool = False, device=None):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.ln2 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.attn = Attention(cfg, device=device)
        if moe:
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = MLP(cfg, device=device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init_weights(cfg, generator)
        (self.moe if hasattr(self, "moe") else self.mlp).init_weights(
            cfg, generator)

    def feed_forward(self, h, cfg, rows=None):
        """The MLP, or the MoE over ``h``'s tokens. With ``rows`` (decode
        only) the MoE dispatches the listed batch rows alone, so its
        capacity counts those rows' tokens; the other rows get 0."""
        if not hasattr(self, "moe"):
            return mlp_apply(self.mlp, h, cfg)
        if rows is None:
            return moe_apply(self.moe, h, cfg)
        out = torch.zeros_like(h)
        out[rows] = moe_apply(self.moe, h[rows], cfg)
        return out

    def forward(self, x, cfg, positions, *, causal: bool = True,
                use_kernel: bool | None = None):
        x = x + attention_block(self.attn, rms_norm(x, self.ln1), cfg,
                                positions, causal=causal,
                                use_kernel=use_kernel)
        return x + self.feed_forward(rms_norm(x, self.ln2), cfg)


class Transformer(nn.Module):
    """Embedding, ``n_layers`` decoder layers (MoE from
    ``moe_start_layer`` on, for an MoE config), final norm and head."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder path is not ported yet "
                "(ROADMAP Queue 1, item 3)"
            )
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.ln_f = _param((cfg.d_model,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dt, device)
        moe_start = cfg.moe.moe_start_layer if cfg.moe else cfg.n_layers
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, moe=i >= moe_start, device=device)
            for i in range(cfg.n_layers)
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's init distributions (``init_params``), drawn
        from ``generator``: embedding N(0, 0.02²), projections
        N(0, 1/d_in), norms one, biases zero."""
        cfg = self.cfg
        normal_(self.embed, 0.02, generator)
        self.ln_f.fill_(1.0)
        if hasattr(self, "lm_head"):
            normal_(self.lm_head, cfg.d_model ** -0.5, generator)
        for layer in self.layers:
            layer.init_weights(cfg, generator)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """A :class:`Transformer` on ``device`` with weights from
    ``generator`` (which must live on ``device``'s type)."""
    model = Transformer(cfg, device=resolve_device(device))
    model.init_weights(generator)
    return model


def embed_tokens(model: Transformer, tokens, embeds=None):
    """Token embedding with an optional frontend (B, T_front, d_model)
    prepended."""
    x = model.embed[tokens]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


@torch.no_grad()
def forward(model: Transformer, tokens, embeds=None, positions=None, *,
            use_kernel: bool | None = None):
    """-> logits (B, S_total, vocab). Every layer's attention goes through
    the dispatcher (``use_kernel`` as in ``ops.attention``)."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, embeds)
    _, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    for layer in model.layers:
        x = layer(x, cfg, positions, causal=True, use_kernel=use_kernel)
    x = rms_norm(x, model.ln_f)
    return x @ model.head()


def init_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """Zeroed ``(L, B, Hkv, S, D)`` K and V caches in the model dtype."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev)}


@torch.no_grad()
def decode_step(model: Transformer, token, cache: dict, pos: int,
                rows=None):
    """token: (B, 1) int; pos: int -> (logits (B, 1, V), cache).

    Writes each layer's new K/V at ``pos`` into ``cache`` in place: into
    every batch row (``rows=None``, exactly the reference's step), or only
    into the batch rows listed in ``rows``. With ``rows`` an MoE layer
    dispatches those rows alone (its capacity counts ``len(rows)``
    tokens), and only their logits are defined (docs/port.md §moe)."""
    cfg = model.cfg
    x = model.embed[token]
    if rows is not None:  # one host-to-device copy per step, not per layer
        rows = torch.as_tensor(rows, dtype=torch.int64, device=x.device)
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.ln1)
        o, _, _ = decode_attention(layer.attn, h, cfg, cache["k"][i],
                                   cache["v"][i], pos, rows)
        x = x + o
        x = x + layer.feed_forward(rms_norm(x, layer.ln2), cfg, rows)
    x = rms_norm(x, model.ln_f)
    return x @ model.head(), cache
