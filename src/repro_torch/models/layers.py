"""Shared neural layers (the port of the JAX package's ``models/layers.py``):
norms, rope, the causal short convolution, attention, the MLPs and the
mixture of experts; and, the port's own, multi-head latent attention
(:class:`MLA`, with or without a query latent and rotary embedding),
sigmoid routing and the held slice of the experts (docs/port.md §mla).

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

from repro_torch import tracing
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


def _causal_conv(x, w, b=None):
    """Depthwise causal convolution: x (B, S, C), taps w (K, C), the last
    one on the current token, and an optional bias (C,) -> (B, S, C)
    (Mamba2's, and Kimi Delta Attention's without a bias)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for j in range(1, k):
        pad = torch.zeros_like(x[:, :j])
        out = out + torch.cat([pad, x[:, :-j]], dim=1) * w[k - 1 - j]
    return out if b is None else out + b


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
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
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
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
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


class MLA(nn.Module):
    """The projections of one multi-head latent attention block
    (DeepSeek-V2 §2.1.2-2.1.3, as Kimi K2 and DeepSeek-V3 run it): the
    query's down- and up-projection ``wq_a`` ``(d, q_rank)``, its norm
    ``q_norm`` and ``wq_b`` ``(q_rank, H·(qk_nope_dim + qk_rope_dim))``,
    or with ``q_rank`` 0 (Kimi Linear) the direct ``wq`` ``(d,
    H·(qk_nope_dim + qk_rope_dim))``;
    the joint key-value down-projection ``wkv_a`` ``(d, kv_rank +
    qk_rope_dim)`` (the latent and the one rotary key a token shares over
    the heads), the latent's norm ``kv_norm`` and ``wkv_b`` ``(kv_rank,
    H·(qk_nope_dim + v_head_dim))``; the output ``wo`` ``(H·v_head_dim,
    d)``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt, d, h = cfg.param_dtype, cfg.d_model, cfg.n_heads
        qk = h * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        if cfg.q_rank:
            self.wq_a = _param((d, cfg.q_rank), dt, device)
            self.q_norm = _param((cfg.q_rank,), dt, device)
            self.wq_b = _param((cfg.q_rank, qk), dt, device)
        else:
            self.wq = _param((d, qk), dt, device)
        self.wkv_a = _param((d, cfg.kv_rank + cfg.qk_rope_dim), dt, device)
        self.kv_norm = _param((cfg.kv_rank,), dt, device)
        self.wkv_b = _param((cfg.kv_rank,
                             h * (cfg.qk_nope_dim + cfg.v_head_dim)), dt,
                            device)
        self.wo = _param((h * cfg.v_head_dim, d), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """Projections N(0, 1/d_in), norms one."""
        for name in ("wq_a", "wq_b", "wq", "wkv_a", "wkv_b", "wo"):
            if hasattr(self, name):
                w = getattr(self, name)
                normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)
        if hasattr(self, "q_norm"):
            self.q_norm.fill_(1.0)
        self.kv_norm.fill_(1.0)


def mla_block(p: MLA, x, cfg, positions, *, causal=True,
              use_kernel: bool | None = None):
    """Multi-head latent attention over ``x`` (B, S, d), in training's
    form (the latent expanded to every head's k and v):

    c_q = RMSNorm(x W_qa); [q_nope | q_pe] = c_q W_qb per head (x W_q
    without a query latent), q_pe roped; a = x W_kva; c_kv =
    RMSNorm(a[:kv_rank]), k_pe = rope(a[kv_rank:]) shared by the heads;
    [k_nope | v] = c_kv W_kvb per head; q = [q_nope | q_pe], k = [k_nope |
    k_pe] (qk_nope_dim + qk_rope_dim each), v of v_head_dim; softmax at
    that width^-1/2 through the dispatcher (the flash kernel at (192, 128)
    on the card); out = merge(o) W_o. Without rotary embedding
    (``use_rope`` False, Kimi Linear's NoPE) q_pe and k_pe keep their
    channels unrotated. Counts a host ``mla.calls``."""
    tracing.add("mla.calls", 1)
    b, s, _ = x.shape
    h, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    eps = cfg.norm_eps
    q = (rms_norm(x @ p.wq_a, p.q_norm, eps) @ p.wq_b if cfg.q_rank
         else x @ p.wq).view(b, s, h, -1)
    a = x @ p.wkv_a
    kv = (rms_norm(a[..., :cfg.kv_rank], p.kv_norm, eps) @ p.wkv_b).view(
        b, s, h, -1)
    q_pe = q[..., nope:].transpose(1, 2)
    k_pe = a[:, :, None, cfg.kv_rank:].transpose(1, 2)
    if cfg.use_rope:
        q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
    q = torch.cat([q[..., :nope].transpose(1, 2), q_pe], dim=-1)
    k = torch.cat([kv[..., :nope].transpose(1, 2),
                   k_pe.expand(b, h, s, rope_d)], dim=-1)
    v = kv[..., nope:].transpose(1, 2)
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
    ``(d, E)`` over all ``E = n_experts``, stacked swiglu experts
    ``w_gate``/``w_up`` ``(E_h, d, f)`` and ``w_down`` ``(E_h, f, d)`` of
    the ``E_h = moe.held`` experts this card holds, the optional shared
    expert, an :class:`MLP` of width ``f * n_shared``, and under sigmoid
    routing the f32 per-expert selection bias ``select_bias`` ``(E,)``,
    which moves the choice and not the gates (so its gradient is 0)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        m, dt = cfg.moe, cfg.param_dtype
        e, d, f = m.held, cfg.d_model, m.d_ff
        self.router = _param((d, m.n_experts), torch.float32, device)
        self.w_gate = _param((e, d, f), dt, device)
        self.w_up = _param((e, d, f), dt, device)
        self.w_down = _param((e, f, d), dt, device)
        if m.n_shared:
            self.shared = MLP(cfg, d_ff=m.d_ff * m.n_shared, device=device)
        if m.score_func == "sigmoid":
            self.select_bias = _param((m.n_experts,), torch.float32, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """The reference's distributions: router N(0, 0.02²), experts
        N(0, 1/d_in), drawn one expert at a time so that the f32
        temporaries stay one matrix on the weights' device; a selection
        bias N(0, 0.01²)."""
        normal_(self.router, 0.02, generator)
        if hasattr(self, "select_bias"):
            normal_(self.select_bias, 0.01, generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            for i in range(w.shape[0]):
                normal_(w[i], 1.0 / math.sqrt(w.shape[1]), generator)
        if hasattr(self, "shared"):
            self.shared.init_weights(cfg, generator)


def moe_router(p: MoE, xt, cfg):
    """The f32 router's choice for the ``(N, d)`` tokens ``xt``: ``(gates,
    idx)``, each ``(N, k)``, the top ``k`` experts per token (of all
    ``n_experts``) and their gates renormalised over the ``k``, then
    times ``route_scale``. Softmax routing chooses by the softmax of the
    logits and gates by it; sigmoid routing scores ``s = σ(logits)``,
    chooses by the top ``k`` of ``s + select_bias`` and gates by ``s``."""
    m = cfg.moe
    logits = xt.float() @ p.router  # (N, E)
    if m.score_func == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = torch.topk(scores + p.select_bias, m.top_k, dim=-1)
        gates = scores.gather(-1, idx)
    else:
        gates, idx = torch.topk(torch.softmax(logits, dim=-1), m.top_k,
                                dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if m.route_scale != 1.0:
        gates = gates * m.route_scale
    return gates, idx


def moe_route(p: MoE, xt, cfg, nblk: int = 1):
    """The reference's dispatch plan for the ``(N, d)`` tokens ``xt`` in
    ``nblk`` contiguous blocks of ``N / nblk``: ``(gates, idx, pos, keep,
    cap)``.

    :func:`moe_router`'s gates and experts; the ``N·k`` assignments
    flattened token-major; ``pos`` is each assignment's place in its
    expert within its block, a running count (int32), and ``keep`` is
    ``pos < cap`` with ``cap = int(max(k, cf·n_loc·k/E))`` priced from
    the block's ``n_loc = N / nblk`` tokens. Of a held slice (``n_held``)
    only the held experts' assignments are counted and kept; one to an
    absent expert has ``pos`` -1, is not kept and takes no capacity."""
    m = cfg.moe
    n = xt.shape[0]
    gates, idx = moe_router(p, xt, cfg)
    cap = int(max(m.top_k, m.capacity_factor * (n // nblk) * m.top_k
                  / m.n_experts))
    # (E_h, nblk, n_loc·k): each held expert's running count of its
    # assignments, along the contiguous last dim
    mine = (idx.reshape(nblk, -1) - m.held_start == torch.arange(
        m.held, device=idx.device)[:, None, None])
    pos = ((torch.cumsum(mine, dim=-1, dtype=torch.int32) * mine).sum(0)
           - 1).reshape(-1)
    return gates, idx, pos, (pos >= 0) & (pos < cap), cap


def _a2a_applies(n: int, cfg) -> bool:
    """The reference's condition for the all-to-all dispatch: an ``a2a``
    mesh and an ``ep`` axis are hinted, the experts divide the ep size
    and the tokens split over dp and ep."""
    dp, ep = hint("dp_size", 1) or 1, hint("ep_size", 1) or 1
    return (hint("a2a") is not None and bool(hint("ep"))
            and cfg.moe.held == cfg.moe.n_experts
            and cfg.moe.n_experts % ep == 0 and n % max(dp * ep, 1) == 0)


def moe_apply(p: MoE, x, cfg):
    """Token-choice top-k MoE with capacity over the ``B·S`` tokens of
    ``x``: the reference's two-stage block-local dispatch, over the
    ``E_h = moe.held`` experts this card holds (every expert but under a
    held slice, ``n_held``).

    The tokens are split into ``nblk = hint("dp_size", 1)`` contiguous
    blocks (one when ``nblk`` does not divide them), each with its own
    capacity (:func:`moe_route`). Each kept assignment names a row of its
    expert's ``(nblk, cap, d)`` buffer; a row takes its token's ``x`` by a
    gather, the experts run as batched products over the ``(E_h,
    nblk·cap, d)`` buffer, and each row's output times its gate is summed
    into its token's in ``x.dtype``; a dropped assignment, or one to an
    absent expert, contributes 0. Nothing here waits for the card. Under
    the reference's ``a2a`` hints the experts run in
    :func:`~repro_torch.parallel.moe_ep.moe_ep_apply` on the hinted mesh
    instead."""
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
    else:
        nblk = hint("dp_size", 1) or 1
        if n % nblk:
            nblk = 1
        gates, idx, pos, keep, cap = moe_route(p, xt, cfg, nblk)
        out = _dispatch(p, xt, gates, idx - m.held_start, pos, keep, cap,
                        nblk, cfg)
    if m.n_shared:
        out = out + mlp_apply(p.shared, xt, cfg)
    return out.reshape(b, s, d)


def _dispatch(p: MoE, xt, gates, local, pos, keep, cap: int, nblk: int,
              cfg):
    """The held experts' part of the MoE over the ``(N, d)`` tokens
    ``xt``: ``local`` is each assignment's expert less ``held_start``,
    ``pos`` and ``keep`` :func:`moe_route`'s. Each kept assignment names
    its ``(E_h, nblk, cap)`` buffer row; a row takes its token's ``x`` and
    its gate, the experts run as batched products, and each row's output
    times its gate is summed into its token's in ``xt.dtype`` (in the
    order of the rows: by expert). An unfilled row ``r`` reads and writes
    a zero row ``N + r`` of its own (gate 0): a row index repeats only
    where a token holds several of the experts, so the summations (the
    output's and, in the backward, the gather's) take the same time
    whatever the routing. The spare row past the buffer takes the
    assignments that are not kept and is dropped."""
    n, d = xt.shape
    e, k = cfg.moe.held, gates.shape[1]
    slot = local.reshape(-1) * nblk
    if nblk > 1:
        slot = slot + torch.arange(n * k, device=xt.device) // (n // nblk * k)
    rows = e * nblk * cap
    dest = torch.where(keep, slot * cap + pos.clamp(0, cap - 1), rows)
    tok = torch.arange(n * k, device=xt.device) // k
    row_tok = torch.arange(n, n + rows + 1, device=xt.device).index_copy_(
        0, dest, tok)[:-1]
    row_gate = torch.zeros(rows + 1, dtype=gates.dtype,
                           device=xt.device).index_copy(
        0, dest, gates.reshape(-1))[:-1]
    buf = torch.cat([xt, xt.new_zeros(rows, d)])[row_tok].view(e, -1, d)
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    y = torch.bmm(h, p.w_down).view(rows, d) * row_gate[:, None].to(xt.dtype)
    out = xt.new_zeros(n + rows, d).index_put((row_tok,), y, accumulate=True)
    return out[:n]


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
