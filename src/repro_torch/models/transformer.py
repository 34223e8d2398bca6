"""Decoder-only and encoder-decoder transformer LMs: dense, MoE, VLM and
audio backbones (the port of the JAX package's ``models/transformer.py``).

Entry points:
  Transformer(cfg, device=...)                 the parameters, nn.Modules
  init_params(cfg, generator, device)          -> Transformer, seeded init
  forward(model, tokens, embeds, positions)    -> logits     (prefill)
  logits(model, tokens, embeds, positions)     -> logits, with a graph
  lm_loss(model, batch)                        -> scalar     (train)
  init_cache(cfg, batch, seq, device, enc_len) -> cache
  decode_step(model, token, cache, pos, rows)  -> (logits, cache)
  encode(model, frames)                        -> encoder states (enc_dec)
  forward_enc_dec(model, frames, tokens)       -> logits          (enc_dec)
  prime_cross_cache(model, cache, enc_states)  -> cache           (enc_dec)
  decode_step_enc_dec(model, token, cache, pos, enc_states)
                                               -> (logits, cache) (enc_dec)

The JAX package scans a stacked ``L`` axis under remat; here the layers
are an ``nn.ModuleList`` walked by a Python loop, each layer under
``torch.utils.checkpoint`` whenever grad mode is on, with the reference's
policy from ``hint("remat", "none")`` (:func:`_remat`, docs/port.md
§parallel). The serving entry points
(``forward``, ``encode``, ``forward_enc_dec``, the decode steps) record no
graph; ``logits``, ``logits_enc_dec`` and ``lm_loss`` do once the
parameters require grad (docs/port.md §train).
The KV cache is a preallocated ``(L, B, Hkv, S, D)`` pair updated in place
(docs/port.md §lm); ``decode_step`` returns the same tensors so that its
signature stays the reference's. An MoE config's first
``moe_start_layer`` layers are dense and the rest MoE (the reference's
``layers`` and ``moe_layers`` groups, in that order in the cache;
docs/port.md §moe). A config with Kimi Delta Attention (``cfg.linear``)
runs it in the layers its pattern names and its attention in the others
(docs/port.md §kda). A VLM config prepends its frontend's ``embeds`` to
the tokens (docs/port.md §vlm). An encoder-decoder config (``enc_dec``,
whisper) holds ``enc_layers``, ``dec_layers`` (:class:`CrossLayer`) and
``ln_enc`` instead of ``layers``; its cache adds the cross-attention K/V
``xk``/``xv``, computed once from the encoder states (docs/port.md
§encdec).
"""

from __future__ import annotations

import threading
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.interop import resolve_device
from repro_torch.parallel.hints import constrain, hint
from repro_torch.parallel.sharding import P

from .kda import KDA, kda_block
from .layers import (
    MLA,
    MLP,
    Attention,
    MoE,
    _param,
    _split_heads,
    attention_block,
    cross_entropy,
    decode_attention,
    mla_block,
    mlp_apply,
    moe_apply,
    normal_,
    rms_norm,
)


def _sp_spec(h):
    """Residual-stream spec: (batch=dp, seq=sp-or-None, d=None)."""
    if not (h.get("dp") or h.get("sp")):
        return None
    return P(h.get("dp"), h.get("sp"), None)


# --------------------------------------------------------------------------
# Remat: the reference's jax.checkpoint policies
# --------------------------------------------------------------------------

_NAMING = threading.local()


def checkpoint_name(x, name: str):
    """``x`` tagged with the reference's remat name (``attn_out``,
    ``ff_out``): with grad on, an ``aten.alias`` of ``x`` run while the
    name is current, which the ``"sublayers"`` policy saves; ``x`` itself
    otherwise. The value is ``x``'s."""
    if not torch.is_grad_enabled():
        return x
    _NAMING.name = name
    try:
        return torch.ops.aten.alias(x)
    finally:
        _NAMING.name = None


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the weight products
    (``mm``; a batched ``bmm`` is recomputed)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_sublayers(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out", "ff_out")``."""
    named = (op is torch.ops.aten.alias.default
             and getattr(_NAMING, "name", None) in ("attn_out", "ff_out"))
    return (CheckpointPolicy.MUST_SAVE if named
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "sublayers": _save_sublayers}


def _remat(layer, policy: str, *args, **kwargs):
    """``layer(*args, **kwargs)``, under ``torch.utils.checkpoint`` (not
    reentrant) when grad mode is on: the backward runs the layer's
    forward again, keeping what ``policy`` saves: ``"none"`` nothing,
    ``"dots"`` the weight products' outputs, ``"sublayers"`` the two
    sublayers' outputs ``attn_out`` and ``ff_out`` (the reference's
    ``_remat_policy``; an unknown name saves nothing, as there).
    ``"off"`` (the port's own) keeps every activation instead. The values
    do not depend on the policy."""
    if policy == "off" or not torch.is_grad_enabled():
        return layer(*args, **kwargs)
    if policy in _POLICIES:
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _POLICIES[policy])
    return checkpoint(layer, *args, use_reentrant=False, **kwargs)


class DecoderLayer(nn.Module):
    """Pre-norm attention + MLP block, or + MoE block with ``moe=True``
    (``_init_layer`` / ``_layer_apply``); the attention is Kimi Delta
    Attention (:class:`~repro_torch.models.kda.KDA`) with ``kda=True``,
    else multi-head latent attention
    (:class:`~repro_torch.models.layers.MLA`) where the config says so
    (``cfg.mla``)."""

    def __init__(self, cfg, *, moe: bool = False, kda: bool = False,
                 device=None):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.ln2 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.attn = (KDA if kda else MLA if cfg.mla else Attention)(
            cfg, device=device)
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
        h = constrain(rms_norm(x, self.ln1, cfg.norm_eps), _sp_spec)
        block = (kda_block if isinstance(self.attn, KDA) else mla_block
                 if cfg.mla else attention_block)
        attn_out = block(self.attn, h, cfg, positions, causal=causal,
                         use_kernel=use_kernel)
        attn_out = checkpoint_name(attn_out, "attn_out")
        x = constrain(x + attn_out, _sp_spec)
        h = constrain(rms_norm(x, self.ln2, cfg.norm_eps), _sp_spec)
        ff_out = checkpoint_name(self.feed_forward(h, cfg), "ff_out")
        return constrain(x + ff_out, _sp_spec)


class CrossLayer(nn.Module):
    """Decoder layer of the encoder-decoder path (``_init_cross_layer`` /
    ``_cross_layer_apply``): causal self-attention, cross-attention to the
    encoder's K/V, MLP, each pre-normed."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.ln_x = _param((cfg.d_model,), cfg.param_dtype, device)
        self.ln2 = _param((cfg.d_model,), cfg.param_dtype, device)
        self.attn = Attention(cfg, device=device)
        self.xattn = Attention(cfg, device=device)
        self.mlp = MLP(cfg, device=device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        for norm in (self.ln1, self.ln_x, self.ln2):
            norm.fill_(1.0)
        self.attn.init_weights(cfg, generator)
        self.xattn.init_weights(cfg, generator)
        self.mlp.init_weights(cfg, generator)

    def cross(self, x, cfg, positions, enc_kv, use_kernel=None):
        """The cross-attention sublayer's output: q from the decoder
        stream (rope at ``positions``), K/V from the encoder, no mask."""
        return attention_block(self.xattn,
                               rms_norm(x, self.ln_x, cfg.norm_eps), cfg,
                               positions, causal=False, kv_override=enc_kv,
                               use_kernel=use_kernel)

    def forward(self, x, cfg, positions, enc_kv, *,
                use_kernel: bool | None = None):
        eps = cfg.norm_eps
        x = x + attention_block(self.attn, rms_norm(x, self.ln1, eps), cfg,
                                positions, causal=True,
                                use_kernel=use_kernel)
        x = x + self.cross(x, cfg, positions, enc_kv, use_kernel)
        return x + mlp_apply(self.mlp, rms_norm(x, self.ln2, eps), cfg)


class Transformer(nn.Module):
    """Embedding, ``n_layers`` decoder layers (MoE from
    ``moe_start_layer`` on, for an MoE config), final norm and head; for
    an encoder-decoder config, ``n_layers`` encoder layers, their norm
    ``ln_enc`` and ``n_layers`` :class:`CrossLayer` decoder layers."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.ln_f = _param((cfg.d_model,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dt, device)
        if cfg.enc_dec:
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, device=device)
                for _ in range(cfg.n_layers))
            self.dec_layers = nn.ModuleList(
                CrossLayer(cfg, device=device) for _ in range(cfg.n_layers))
            self.ln_enc = _param((cfg.d_model,), dt, device)
            return
        moe_start = cfg.moe.moe_start_layer if cfg.moe else cfg.n_layers
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, moe=i >= moe_start, kda=cfg.is_kda(i),
                         device=device)
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
        layers = self.layers if not cfg.enc_dec else [
            *self.enc_layers, *self.dec_layers]
        if cfg.enc_dec:
            self.ln_enc.fill_(1.0)
        for layer in layers:
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


def logits(model: Transformer, tokens, embeds=None, positions=None, *,
           use_kernel: bool | None = None):
    """-> logits (B, S_total, vocab). Every layer's attention goes through
    the dispatcher (``use_kernel`` as in ``ops.attention``). Records a
    graph when the parameters require grad (the loss path)."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, embeds)
    _, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    policy = hint("remat", "none")
    for layer in model.layers:
        x = _remat(layer, policy, x, cfg, positions, causal=True,
                   use_kernel=use_kernel)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    return x @ model.head()


@torch.no_grad()
def forward(model: Transformer, tokens, embeds=None, positions=None, *,
            use_kernel: bool | None = None):
    """:func:`logits` without a graph: the serving forward."""
    return logits(model, tokens, embeds, positions, use_kernel=use_kernel)


def _no_decode(cfg) -> None:
    """Kimi Delta Attention and multi-head latent attention train and
    prefill here; their decode (a recurrent state cache, an absorbed
    latent cache) is not ported."""
    if cfg.linear:
        raise NotImplementedError(
            f"{cfg.name}: Kimi Delta Attention has no recurrent state cache "
            "or decode path in the port (training and prefill only; "
            "docs/port.md §kda)")
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention has no KV cache or "
            "decode path in the port (training and prefill only; "
            "docs/port.md §mla)")


def init_cache(cfg, batch: int, seq: int, device="cuda",
               enc_len: int | None = None) -> dict:
    """Zeroed ``(L, B, Hkv, S, D)`` K and V caches in the model dtype; an
    encoder-decoder config adds the cross-attention ``xk``/``xv`` over
    ``enc_len`` frames (default ``4 * seq``), which
    :func:`prime_cross_cache` fills once. Raises for Kimi Delta Attention
    and multi-head latent attention."""
    _no_decode(cfg)
    dev = resolve_device(device)

    def kv(s):
        return torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, s,
                            cfg.head_dim), dtype=cfg.param_dtype, device=dev)

    cache = {"k": kv(seq), "v": kv(seq)}
    if cfg.enc_dec:
        enc_len = enc_len if enc_len is not None else seq * 4
        cache["xk"], cache["xv"] = kv(enc_len), kv(enc_len)
    return cache


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
    _no_decode(cfg)
    x = model.embed[token]
    if rows is not None:  # one host-to-device copy per step, not per layer
        rows = torch.as_tensor(rows, dtype=torch.int64, device=x.device)
    eps = cfg.norm_eps
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.ln1, eps)
        o, _, _ = decode_attention(layer.attn, h, cfg, cache["k"][i],
                                   cache["v"][i], pos, rows)
        x = x + o
        x = x + layer.feed_forward(rms_norm(x, layer.ln2, eps), cfg, rows)
    x = rms_norm(x, model.ln_f, eps)
    return x @ model.head(), cache


# --------------------------------------------------------------------------
# Encoder-decoder (whisper): docs/port.md §encdec
# --------------------------------------------------------------------------


def _encode(model: Transformer, frames, *, use_kernel: bool | None = None):
    """Encoder stack over the stubbed frame embeddings ``(B, T, d)``, cast
    to the parameter dtype: non-causal self-attention, then ``ln_enc``."""
    cfg = model.cfg
    x = frames.to(cfg.param_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    policy = hint("remat", "none")
    for layer in model.enc_layers:
        x = _remat(layer, policy, x, cfg, positions, causal=False,
                   use_kernel=use_kernel)
    return rms_norm(x, model.ln_enc, cfg.norm_eps)


@torch.no_grad()
def encode(model: Transformer, frames, *, use_kernel: bool | None = None):
    """The encoder states of ``frames`` (:func:`_encode`), no graph."""
    return _encode(model, frames, use_kernel=use_kernel)


def _enc_kv(layer: CrossLayer, cfg, enc_states):
    """One decoder layer's cross-attention K/V ``(B, Hkv, T, D)`` from the
    encoder states: projection and bias, no norm and no rope."""
    kx = enc_states @ layer.xattn.wk
    vx = enc_states @ layer.xattn.wv
    if cfg.qkv_bias:
        kx, vx = kx + layer.xattn.bk, vx + layer.xattn.bv
    return _split_heads(kx, cfg.n_kv_heads), _split_heads(vx, cfg.n_kv_heads)


def _cross_layer(layer: CrossLayer, x, cfg, positions, enc, use_kernel):
    """One decoder layer with its cross-attention K/V from ``enc``
    (computed inside the layer, so that remat recomputes them)."""
    return layer(x, cfg, positions, _enc_kv(layer, cfg, enc),
                 use_kernel=use_kernel)


def logits_enc_dec(model: Transformer, frames, tokens, *,
                   use_kernel: bool | None = None):
    """Whisper-style: encode ``frames``, decode ``tokens`` with
    cross-attention -> logits ``(B, S, vocab)``. Records a graph when the
    parameters require grad (the loss path)."""
    cfg = model.cfg
    enc = _encode(model, frames, use_kernel=use_kernel)
    x = model.embed[tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    # the reference's decoder scan saves nothing, whatever the hint
    off = hint("remat") == "off"
    for layer in model.dec_layers:
        x = _remat(_cross_layer, "off" if off else "none", layer, x, cfg,
                   positions, enc, use_kernel)
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    return x @ model.head()


@torch.no_grad()
def forward_enc_dec(model: Transformer, frames, tokens, *,
                    use_kernel: bool | None = None):
    """:func:`logits_enc_dec` without a graph: the serving forward."""
    return logits_enc_dec(model, frames, tokens, use_kernel=use_kernel)


@torch.no_grad()
def prime_cross_cache(model: Transformer, cache: dict, enc_states) -> dict:
    """A copy of ``cache`` whose ``xk``/``xv`` are every decoder layer's
    cross-attention K/V from ``enc_states``, stacked ``(L, B, Hkv, T, D)``
    (the one-time fill; ``k``/``v`` are the same tensors)."""
    kvs = [_enc_kv(layer, model.cfg, enc_states)
           for layer in model.dec_layers]
    cache = dict(cache)
    cache["xk"] = torch.stack([k for k, _ in kvs])
    cache["xv"] = torch.stack([v for _, v in kvs])
    return cache


@torch.no_grad()
def decode_step_enc_dec(model: Transformer, token, cache: dict, pos: int,
                        enc_states=None, *, use_kernel: bool | None = None):
    """token: (B, 1) int; pos: int -> (logits (B, 1, V), cache).

    The self-attention K/V are written at ``pos`` in place, as
    :func:`decode_step` writes them; the cross-attention reads the cached
    ``xk``/``xv`` through the dispatcher (one launch per layer at Sq 1 on
    the card), its q roped at ``pos``. ``enc_states`` is needed only when
    the cache holds no ``xk``: the cache is then primed first (the
    reference's slow path)."""
    cfg = model.cfg
    if enc_states is not None and "xk" not in cache:
        cache = prime_cross_cache(model, cache, enc_states)
    x = model.embed[token]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    eps = cfg.norm_eps
    for i, layer in enumerate(model.dec_layers):
        o, _, _ = decode_attention(layer.attn, rms_norm(x, layer.ln1, eps),
                                   cfg, cache["k"][i], cache["v"][i], pos)
        x = x + o
        x = x + layer.cross(x, cfg, positions,
                            (cache["xk"][i], cache["xv"][i]), use_kernel)
        x = x + mlp_apply(layer.mlp, rms_norm(x, layer.ln2, eps), cfg)
    x = rms_norm(x, model.ln_f, eps)
    return x @ model.head(), cache


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


def lm_loss(model: Transformer, batch: dict, *,
            use_kernel: bool | None = None):
    """batch: {tokens, labels, [embeds], [frames]} -> scalar loss, with a
    graph when the parameters require grad. A VLM's logits over its
    frontend embeds are dropped before the loss (docs/port.md §train)."""
    if model.cfg.enc_dec:
        out = logits_enc_dec(model, batch["frames"], batch["tokens"],
                             use_kernel=use_kernel)
    else:
        embeds = batch.get("embeds")
        out = logits(model, batch["tokens"], embeds, use_kernel=use_kernel)
        if embeds is not None:
            out = out[:, embeds.shape[1]:]
    return cross_entropy(out, batch["labels"])
