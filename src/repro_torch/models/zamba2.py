"""Zamba2-style hybrid (the port of the JAX package's ``models/zamba2.py``):
a Mamba2 backbone with a single *shared* (weight-tied) attention+MLP
block applied every ``attn_period`` SSM layers.

Each application site of the shared block has its own KV cache at decode
time, though the weights are shared. Per-site LoRA deltas of the released
model are omitted, as in the reference.

Layer schedule for n_layers=81, attn_period=6:
  13 groups of [6 x mamba2 -> shared-attn-block] + 3 trailing mamba2 layers.

Entry points:
  Zamba2(cfg, device=...)                      the parameters, nn.Modules
  init_params(cfg, generator, device)          -> Zamba2, seeded init
  forward(model, tokens, use_kernel)           -> logits     (prefill)
  logits(model, tokens, use_kernel)            -> logits, with a graph
  init_cache(cfg, batch, seq, device)          -> cache
  decode_step(model, token, cache, pos, rows)  -> (logits, cache)

The shared block's prefill attention goes through ``ops.attention``, so
it launches the flash kernel on a CUDA tensor (13 times per prefill at
full width, head dim 112). A request's first decode step, at position 0,
starts from a zero SSM state for its rows; the reference carries a slot's
old state into the next request (docs/port.md §hybrid).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.interop import resolve_device
from repro_torch.parallel.hints import hint

from .layers import _param, decode_attention, mlp_apply, normal_, rms_norm
from .mamba2 import Mamba2, mamba2_apply, mamba2_decode, mamba2_state_init
from .transformer import DecoderLayer, _remat


def schedule(cfg) -> tuple[int, int, int]:
    """-> (n_groups, group_len, n_tail)."""
    g = cfg.attn_period
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


class Zamba2(nn.Module):
    """Embedding, ``n_layers`` Mamba2 layers, the one shared block, final
    norm and head."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(
            Mamba2(cfg, device=device) for _ in range(cfg.n_layers))
        self.shared = DecoderLayer(cfg, device=device)
        self.ln_f = _param((cfg.d_model,), dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), dt, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's init distributions (``init_params``), drawn
        from ``generator``."""
        cfg = self.cfg
        normal_(self.embed, 0.02, generator)
        for layer in self.layers:
            layer.init_weights(cfg, generator)
        self.shared.init_weights(cfg, generator)
        self.ln_f.fill_(1.0)
        if hasattr(self, "lm_head"):
            normal_(self.lm_head, cfg.d_model ** -0.5, generator)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """A :class:`Zamba2` on ``device`` with weights from ``generator``
    (which must live on ``device``'s type)."""
    model = Zamba2(cfg, device=resolve_device(device))
    model.init_weights(generator)
    return model


def _group(layers, shared, x, cfg, positions, use_kernel):
    """Mamba2 ``layers`` in turn, then the ``shared`` block (none for a
    tail layer): one remat unit of the reference's scans."""
    for layer in layers:
        x = x + mamba2_apply(layer, x, cfg)
    if shared is not None:
        x = shared(x, cfg, positions, causal=True, use_kernel=use_kernel)
    return x


def logits(model: Zamba2, tokens, *, use_kernel: bool | None = None):
    """-> logits (B, S, vocab). The shared block's attention goes through
    the dispatcher (``use_kernel`` as in ``ops.attention``). Records a
    graph when the parameters require grad (the loss path).

    With grad on, each group (its ``g`` Mamba2 layers, then the shared
    block) and each tail layer runs under ``torch.utils.checkpoint`` with
    nothing saved, as the reference's ``jax.checkpoint(group_body,
    policy=nothing_saveable)`` and ``jax.checkpoint(tail_body)``: the
    backward runs its forward again. ``hint("remat") == "off"`` keeps
    every activation instead (the port's own, as in ``transformer``)."""
    cfg = model.cfg
    n_groups, g, _ = schedule(cfg)
    x = model.embed[tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    policy = "off" if hint("remat") == "off" else "none"
    layers = list(model.layers)
    for i in range(n_groups):
        x = _remat(_group, policy, layers[i * g:(i + 1) * g], model.shared,
                   x, cfg, positions, use_kernel)
    for layer in layers[n_groups * g:]:
        x = _remat(_group, policy, [layer], None, x, cfg, positions,
                   use_kernel)
    x = rms_norm(x, model.ln_f)
    return x @ model.head()


@torch.no_grad()
def forward(model: Zamba2, tokens, *, use_kernel: bool | None = None):
    """:func:`logits` without a graph: the serving forward."""
    return logits(model, tokens, use_kernel=use_kernel)


def init_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The stacked SSM state ``(L, B, ...)`` and each shared-block site's
    zeroed ``(n_groups, B, Hkv, S, D)`` K and V."""
    n_groups, _, _ = schedule(cfg)
    dev = resolve_device(device)
    state = mamba2_state_init(cfg, batch, dev)
    shape = (n_groups, batch, cfg.n_kv_heads, seq, cfg.head_dim)
    return {
        "ssm": {name: x.new_zeros((cfg.n_layers,) + tuple(x.shape))
                for name, x in state.items()},
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
    }


@torch.no_grad()
def decode_step(model: Zamba2, token, cache: dict, pos: int, rows=None):
    """token: (B, 1) int; pos: int -> (logits (B, 1, V), cache).

    Writes each layer's new SSM state and each site's new K/V into
    ``cache`` in place: into every batch row (``rows=None``, the
    reference's step), or only into the rows listed in ``rows``. At
    ``pos`` 0 the stepped rows' SSM state is zeroed first: position 0 is
    a request's first token, whatever the slot held before."""
    cfg = model.cfg
    n_groups, g, _ = schedule(cfg)
    x = model.embed[token]
    if rows is not None:  # one host-to-device copy per step, not per layer
        rows = torch.as_tensor(rows, dtype=torch.int64, device=x.device)
    ssm = cache["ssm"]
    if pos == 0:
        for st in ssm.values():
            if rows is None:
                st.zero_()
            else:
                st[:, rows] = 0
    shared = model.shared
    for i, layer in enumerate(model.layers):
        state = {name: st[i] for name, st in ssm.items()}
        y, _ = mamba2_decode(layer, x, cfg, state, rows)
        x = x + y
        if i < n_groups * g and i % g == g - 1:
            site = i // g
            o, _, _ = decode_attention(shared.attn, rms_norm(x, shared.ln1),
                                       cfg, cache["k"][site],
                                       cache["v"][site], pos, rows)
            x = x + o
            x = x + mlp_apply(shared.mlp, rms_norm(x, shared.ln2), cfg)
    x = rms_norm(x, model.ln_f)
    return x @ model.head(), cache
