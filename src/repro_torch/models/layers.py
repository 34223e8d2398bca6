"""Shared neural layers (the port of the JAX package's ``models/layers.py``):
norms, rope, attention, the MLPs and the mixture of experts.

Conventions:
* parameters live in ``nn.Module``s (:class:`Attention`, :class:`MLP`) as
  ``(d_in, d_out)`` matrices applied as ``x @ w``, the JAX package's layout,
  so carried-across weights need no transpose;
* norms, rope and softmax run in f32 and cast back to the input dtype;
* the functions take the module whose weights they apply, as the JAX ones
  take a parameter dict.

The reference's sharding hints are read as it reads them
(``parallel/hints.py``): the MoE dispatch splits its tokens into
``hint("dp_size")`` blocks that each price their own capacity, and under
the ``a2a`` hint runs ``parallel/moe_ep.py``'s all-to-all dispatch on the
hinted mesh; ``constrain`` is called where the reference calls it and
changes no value on one controller (docs/port.md §parallel).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ops import attention as _attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.parallel import moe_ep
from repro_torch.parallel.hints import constrain, hint
from repro_torch.parallel.sharding import P

# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    """A parameter created frozen, so that serving records no graph; the
    train step turns grad on for what it trains (docs/port.md §train)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def normal_(w: torch.Tensor, std: float, generator: torch.Generator):
    """Fill ``w`` with N(0, std²), drawn in f32 on the generator's device
    (``dense_init`` / ``embed_init`` of the reference)."""
    x = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    w.copy_(x.mul_(std))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """Mean-centred norm with a bias, in f32 (the population variance, as
    ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, H, S, D); positions: (B, S) or (S,).

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` and re-stacks
    them pair by pair, as the reference does (not the ``rotate_half``
    split-halves convention)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs  # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


class Attention(nn.Module):
    """The projections of one attention block (``attn_init``)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        hd, dt = cfg.head_dim, cfg.param_dtype
        self.wq = _param((cfg.d_model, cfg.n_heads * hd), dt, device)
        self.wk = _param((cfg.d_model, cfg.n_kv_heads * hd), dt, device)
        self.wv = _param((cfg.d_model, cfg.n_kv_heads * hd), dt, device)
        self.wo = _param((cfg.n_heads * hd, cfg.d_model), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads * hd,), dt, device)
            self.bk = _param((cfg.n_kv_heads * hd,), dt, device)
            self.bv = _param((cfg.n_kv_heads * hd,), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), dt, device)
            self.k_norm = _param((hd,), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            normal_(w, 1.0 / math.sqrt(cfg.d_model), generator)
        normal_(self.wo, 1.0 / math.sqrt(cfg.n_heads * cfg.head_dim),
                generator)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(self, name):
                getattr(self, name).fill_(1.0)


def _split_heads(x, n_heads: int):
    b, s, _ = x.shape
    return x.view(b, s, n_heads, -1).transpose(1, 2)  # (B,H,S,D)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attn_q(p: Attention, x, cfg, positions):
    """The query of :func:`attn_qkv` alone: projection, bias, head split,
    qk-norm, rope. (B, Hq, S, D)."""
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = _split_heads(q, cfg.n_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def attn_qkv(p: Attention, x, cfg, positions):
    """Projections, head split, qk-norm (after the split, before rope),
    rope. Returns (B, H, S, D) q, k, v."""
    q = attn_q(p, x, cfg, positions)
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    k = _split_heads(k, cfg.n_kv_heads)
    v = _split_heads(v, cfg.n_kv_heads)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm)
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p: Attention, x, cfg, positions, *, causal=True,
                    kv_override=None, use_kernel: bool | None = None):
    """Full-sequence attention (train/prefill) through the dispatcher:
    the flash kernel on a CUDA tensor, the chunked version on the CPU
    (``use_kernel`` overrides). kv_override supplies cross-attention K/V
    (already head-split); the block's own k and v, which the reference
    computes and discards there, are then not computed."""
    if kv_override is None:
        q, k, v = attn_qkv(p, x, cfg, positions)
    else:
        q = attn_q(p, x, cfg, positions)
        k, v = kv_override
    o = _attention(q, k, v, causal=causal, window=cfg.sliding_window,
                   use_kernel=use_kernel)
    return _merge_heads(o) @ p.wo


def _kv_decode_spec(cfg):
    """Decode-time KV-cache spec: heads over 'model' when they divide, else
    *sequence*-sharded over 'model' (flash-decoding layout)."""

    def spec(h):
        ep, nep = h.get("ep"), h.get("ep_size", 1) or 1
        if not ep:
            return None
        if cfg.n_kv_heads % nep == 0:
            return P(h.get("dp"), ep, None, None)
        return P(h.get("dp"), None, ep, None)

    return spec


def decode_attention(p: Attention, x, cfg, cache_k, cache_v, pos: int,
                     rows=None):
    """Single-token decode against a (B, Hkv, S, D) cache; pos: index of
    the new token. Writes the new K/V at ``pos`` in place — into every
    batch row, or only into ``rows`` (an int64 index tensor on the cache's
    device) when given — and returns ``(out, cache_k, cache_v)``. Plain
    torch, as the reference computes it outside any kernel."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = attn_qkv(p, x, cfg, positions)
    if rows is None:
        cache_k[:, :, pos] = k_new[:, :, 0]
        cache_v[:, :, pos] = v_new[:, :, 0]
    else:
        cache_k[rows, :, pos] = k_new[rows, :, 0]
        cache_v[rows, :, pos] = v_new[rows, :, 0]
    kv_spec = _kv_decode_spec(cfg)
    cache_k = constrain(cache_k, kv_spec)
    cache_v = constrain(cache_v, kv_spec)
    s = cache_k.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    kk = cache_k.repeat_interleave(group, dim=1) if group > 1 else cache_k
    vv = cache_v.repeat_interleave(group, dim=1) if group > 1 else cache_v
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (
        cfg.head_dim ** -0.5)
    idx = torch.arange(s, device=x.device)
    valid = idx <= pos
    if cfg.sliding_window > 0:
        valid &= idx > pos - cfg.sliding_window
    logits = torch.where(valid, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", pr, vv.float()).to(x.dtype)
    return _merge_heads(o) @ p.wo, cache_k, cache_v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """The feed-forward block (``mlp_init``): gate/up/down for swiglu,
    up/down otherwise."""

    def __init__(self, cfg, d_ff: int | None = None, *, device=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = cfg.param_dtype
        if cfg.activation == "swiglu":
            self.w_gate = _param((cfg.d_model, d_ff), dt, device)
        self.w_up = _param((cfg.d_model, d_ff), dt, device)
        self.w_down = _param((d_ff, cfg.d_model), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        if hasattr(self, "w_gate"):
            normal_(self.w_gate, 1.0 / math.sqrt(cfg.d_model), generator)
        normal_(self.w_up, 1.0 / math.sqrt(cfg.d_model), generator)
        normal_(self.w_down, 1.0 / math.sqrt(self.w_down.shape[0]),
                generator)


def mlp_apply(p: MLP, x, cfg):
    if cfg.activation == "swiglu":
        return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    h = x @ p.w_up
    if cfg.activation == "squared_relu":
        h = torch.square(F.relu(h))
    else:  # gelu, tanh-approximated as jax.nn.gelu's default
        h = F.gelu(h, approximate="tanh")
    return h @ p.w_down


# --------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k with capacity, block dispatch)
# --------------------------------------------------------------------------


class MoE(nn.Module):
    """The experts of one MoE block (``moe_init``): an f32 router
    ``(d, E)``, stacked swiglu experts ``w_gate``/``w_up`` ``(E, d, f)``
    and ``w_down`` ``(E, f, d)``, and the optional shared expert, an
    :class:`MLP` of width ``f * n_shared``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        m, dt = cfg.moe, cfg.param_dtype
        e, d, f = m.n_experts, cfg.d_model, m.d_ff
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, f), dt, device)
        self.w_up = _param((e, d, f), dt, device)
        self.w_down = _param((e, f, d), dt, device)
        if m.n_shared:
            self.shared = MLP(cfg, d_ff=m.d_ff * m.n_shared, device=device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """The reference's distributions: router N(0, 0.02²), experts
        N(0, 1/d_in), drawn one expert at a time so that the f32
        temporaries stay one matrix on the weights' device."""
        normal_(self.router, 0.02, generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            for i in range(w.shape[0]):
                normal_(w[i], 1.0 / math.sqrt(w.shape[1]), generator)
        if hasattr(self, "shared"):
            self.shared.init_weights(cfg, generator)


def moe_router(p: MoE, xt, cfg):
    """Softmax of the f32 router logits over the ``(N, d)`` tokens
    ``xt``, and the top ``k`` experts per token: ``(gates, idx)``, each
    ``(N, k)``, the gates renormalised over the ``k``."""
    logits = xt.float() @ p.router  # (N, E)
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.moe.top_k,
                            dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def moe_route(p: MoE, xt, cfg, nblk: int = 1):
    """The reference's dispatch plan for the ``(N, d)`` tokens ``xt`` in
    ``nblk`` contiguous blocks of ``N / nblk``: ``(gates, idx, pos, keep,
    cap)``.

    :func:`moe_router`'s gates and experts; the ``N·k`` assignments
    flattened token-major; ``pos`` is each assignment's place in its
    expert within its block, a running one-hot count, and ``keep`` is
    ``pos < cap`` with ``cap = int(max(k, cf·n_loc·k/E))`` priced from
    the block's ``n_loc = N / nblk`` tokens."""
    m = cfg.moe
    n = xt.shape[0]
    gates, idx = moe_router(p, xt, cfg)
    cap = int(max(m.top_k, m.capacity_factor * (n // nblk) * m.top_k
                  / m.n_experts))
    onehot = F.one_hot(idx.reshape(nblk, -1), m.n_experts)  # int64
    pos = ((torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1).reshape(-1)
    return gates, idx, pos, pos < cap, cap


def _a2a_applies(n: int, cfg) -> bool:
    """The reference's condition for the all-to-all dispatch: an ``a2a``
    mesh and an ``ep`` axis are hinted, the experts divide the ep size
    and the tokens split over dp and ep."""
    dp, ep = hint("dp_size", 1) or 1, hint("ep_size", 1) or 1
    return (hint("a2a") is not None and bool(hint("ep"))
            and cfg.moe.n_experts % ep == 0 and n % max(dp * ep, 1) == 0)


def moe_apply(p: MoE, x, cfg):
    """Token-choice top-k MoE with capacity over the ``B·S`` tokens of
    ``x``: the reference's two-stage block-local dispatch.

    The tokens are split into ``nblk = hint("dp_size", 1)`` contiguous
    blocks (one when ``nblk`` does not divide them), each with its own
    capacity (:func:`moe_route`). Each kept assignment is scattered into
    its expert's ``(nblk, cap, d)`` buffer, the experts run as batched
    products over the ``(E, nblk·cap, d)`` buffer, and each token sums
    its kept experts' outputs times their gates in ``x.dtype``; a dropped
    assignment contributes 0. Nothing here waits for the card: a dropped
    assignment is written to a spare row past the buffer, which the
    experts never read. Under the reference's ``a2a`` hints the experts
    run in :func:`~repro_torch.parallel.moe_ep.moe_ep_apply` on the
    hinted mesh instead."""
    m = cfg.moe
    b, s, d = x.shape
    n, k, e = b * s, m.top_k, m.n_experts
    xt = x.reshape(n, d)
    if _a2a_applies(n, cfg):
        gates, idx = moe_router(p, xt, cfg)
        out = moe_ep.moe_ep_apply(
            xt, idx, gates, p.w_gate, p.w_up, p.w_down,
            mesh=hint("a2a"), dp_axes=hint("dp"), ep_axis=hint("ep"),
            fsdp_axes=hint("fsdp"), capacity_factor=m.capacity_factor,
            top_k=k, n_experts=e).to(x.device)
        if m.n_shared:
            out = out + mlp_apply(p.shared, xt, cfg)
        return out.reshape(b, s, d)
    nblk = hint("dp_size", 1) or 1
    if n % nblk:
        nblk = 1
    gates, idx, pos, keep, cap = moe_route(p, xt, cfg, nblk)
    # slot of each assignment in the (E, nblk, cap) buffer
    slot = idx.reshape(-1) * nblk
    if nblk > 1:
        slot = slot + torch.arange(n * k, device=x.device) // (n // nblk * k)
    slot = slot * cap + pos.clamp(max=cap - 1)  # (N·k,)
    rows = e * nblk * cap
    buf = torch.zeros((rows + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, torch.where(keep, slot, rows),
                    xt.repeat_interleave(k, dim=0))
    buf = buf[:-1].view(e, nblk * cap, d)
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    y = torch.bmm(h, p.w_down).view(rows, d)
    gathered = torch.where(keep[:, None], y[slot], 0)
    out = (gathered.view(n, k, d) * gates[..., None].to(x.dtype)).sum(1)
    if m.n_shared:
        out = out + mlp_apply(p.shared, xt, cfg)
    return out.reshape(b, s, d)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def cross_entropy(logits, labels, ignore_index: int = -100):
    """logits: (..., V) f32/bf16; labels int (int32 as the reference's
    batches, or int64). Mean over non-ignored."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
