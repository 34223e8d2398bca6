"""Kimi Delta Attention (KDA; the Kimi Linear report, arXiv:2510.26692
§3): a gated delta rule whose decay is per channel, the linear attention
of three of every four of Kimi Linear's layers (docs/port.md §kda).

Per layer, of x (B, S, d), H heads of dk = dv = ``head_dim``:

  q = L2Norm(SiLU(ShortConv(x W_q))), k = L2Norm(SiLU(ShortConv(x W_k))),
  v = SiLU(ShortConv(x W_v))          (depthwise causal, no bias)
  g = −exp(A_log[h]) · softplus(x W_fa W_fb + dt_bias)   (log decay ≤ 0)
  β = sigmoid(x W_b)                                    (one a head)
  S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ
  o_t = S_tᵀ q_t / √dk
  out = W_o · concat_h(RMSNorm_h(o) ⊙ sigmoid(x W_ga W_gb))

The recurrence runs in chunks of C tokens (:func:`kda_chunked`, plain
torch, f32): within a chunk the WY form S_t = Diag(Γ_t) S_0 +
Σ_{i≤t} Diag(Γ_t / Γ_i) k_i w_iᵀ, Γ the decay since the chunk's start,
gives the rows w = T (V − (K ⊙ Γ) S_0) by one triangular solve, T = (I +
A)⁻¹ Diag(β) with A_{ti} = β_t Σ_c k_tc k_ic exp(G_tc − G_ic) (i < t);
across chunks one (dk, dv) state a head is carried by a loop of one
product a chunk (the chunk's affine map of the state). Every
exponent taken is ≤ 0: the pair products exp(G_t − G_i) run directly
inside sub-chunks of :data:`SUB` tokens (masked on the exponent, as
``mamba2._ssd_chunked`` masks) and, between sub-chunks, factorised
through the cumulative decay just before the later sub-chunk.

:class:`KDAFn` is the autograd Function around it (its backward runs the
chunked form again under autograd); the trace credits KDA's device time
by its name (``KDAFn``, ``KDAFnBackward``). Each block counts a host
``kda.calls``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tracing

from .layers import _causal_conv, _param, normal_, rms_norm

#: Tokens of a chunk of the delta rule.
CHUNK = 64

#: Tokens of a sub-chunk, inside which the decayed pair products are taken
#: directly (a (SUB, SUB, dk) tensor a sub-chunk).
SUB = 8

#: The L2 norm's epsilon under the root (the published kernels').
L2_EPS = 1e-6


class KDA(nn.Module):
    """One KDA layer's parameters: ``wq``, ``wk``, ``wv`` ``(d, H·dk)``,
    their convolutions' taps ``conv_q``, ``conv_k``, ``conv_v`` ``(K,
    H·dk)``; the decay's ``wf_a`` ``(d, dk)``, ``wf_b`` ``(dk, H·dk)``,
    ``A_log`` ``(H,)`` and ``dt_bias`` ``(H·dk,)`` (both f32); β's ``wb``
    ``(d, H)``; the output gate's ``wg_a``, ``wg_b``; the per-head norm
    ``o_norm`` ``(dk,)`` and ``wo`` ``(H·dk, d)``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        la, dt, d = cfg.linear, cfg.param_dtype, cfg.d_model
        hd, w = la.head_dim, la.n_heads * la.head_dim
        self.wq = _param((d, w), dt, device)
        self.wk = _param((d, w), dt, device)
        self.wv = _param((d, w), dt, device)
        self.conv_q = _param((la.conv, w), dt, device)
        self.conv_k = _param((la.conv, w), dt, device)
        self.conv_v = _param((la.conv, w), dt, device)
        self.wf_a = _param((d, hd), dt, device)
        self.wf_b = _param((hd, w), dt, device)
        self.A_log = _param((la.n_heads,), torch.float32, device)
        self.dt_bias = _param((w,), torch.float32, device)
        self.wb = _param((d, la.n_heads), dt, device)
        self.wg_a = _param((d, hd), dt, device)
        self.wg_b = _param((hd, w), dt, device)
        self.o_norm = _param((hd,), dt, device)
        self.wo = _param((w, d), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """Projections N(0, 1/d_in), the taps N(0, 1/K), ``A_log`` the log
        of U(1, 16) a head, ``dt_bias`` softplus⁻¹ of a step log-uniform on
        [1e-3, 1e-1] a channel (Mamba2's law), the norm one."""
        for w in (self.wq, self.wk, self.wv, self.wf_a, self.wf_b, self.wb,
                  self.wg_a, self.wg_b, self.wo):
            normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)
        for w in (self.conv_q, self.conv_k, self.conv_v):
            normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)
        dev = generator.device
        u = torch.rand(self.A_log.shape, generator=generator, device=dev)
        self.A_log.copy_(torch.log(1.0 + 15.0 * u))
        u = torch.rand(self.dt_bias.shape, generator=generator, device=dev)
        step = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                               - math.log(1e-3)))
        self.dt_bias.copy_(step + torch.log(-torch.expm1(-step)))
        self.o_norm.fill_(1.0)


def _l2norm(x):
    """``x`` over its last dim's L2 norm, in f32."""
    x = x.float()
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def _pairs(xs, k, G, sub: int):
    """For each ``x`` of ``xs`` (each ``(..., C, D)``, as ``k`` and the
    cumulative log decay ``G``): ``P[t, i] = Σ_c x_tc k_ic exp(G_tc −
    G_ic)`` for i ≤ t, 0 above, ``(..., C, C)``. Inside a sub-chunk of
    ``sub`` tokens the decay is taken pair by pair, its mask on the
    exponent; between sub-chunks through ``G_r``, the decay just before
    the later one (0 before the first), so that exp(G_t − G_r) and
    exp(G_r − G_i) both have exponents ≤ 0."""
    *lead, c, d = k.shape
    ns = c // sub
    ks, Gs = k.view(*lead, ns, sub, d), G.view(*lead, ns, sub, d)
    tri = torch.ones((sub, sub), dtype=torch.bool, device=k.device).tril()
    e = torch.exp(torch.where(tri[:, :, None],
                              Gs[..., :, None, :] - Gs[..., None, :, :],
                              float("-inf")))  # (..., ns, t, i, D)
    y = e * ks[..., None, :, :]
    ref = torch.cat([torch.zeros_like(Gs[..., :1, 0, :]), Gs[..., :-1, -1, :]],
                    dim=-2)  # (..., ns, D): G just before sub-chunk a
    before = (torch.arange(c, device=k.device)[None, :]
              < sub * torch.arange(ns, device=k.device)[:, None])
    k_off = k[..., None, :, :] * torch.exp(torch.where(
        before[:, :, None], ref[..., :, None, :] - G[..., None, :, :],
        float("-inf")))  # (..., ns, C, D)
    eye = torch.eye(ns, dtype=k.dtype, device=k.device)[:, None, :, None]
    out = []
    for x in xs:
        xv = x.view(*lead, ns, sub, d)
        diag = (y @ xv[..., None]).squeeze(-1)  # (..., ns, t, i)
        off = (xv * torch.exp(Gs - ref[..., :, None, :])) @ k_off.transpose(
            -1, -2)  # (..., ns, t, C): 0 at and after the own sub-chunk
        p = off.view(*lead, ns, sub, ns, sub) + diag[..., :, :, None, :] * eye
        out.append(p.reshape(*lead, c, c))
    return out


def kda_chunked(q, k, v, g, beta, chunk: int = CHUNK):
    """The gated delta rule over ``q``, ``k`` ``(B, S, H, dk)`` (L2
    normalised), ``v`` ``(B, S, H, dv)``, the log decay ``g`` ``(B, S, H,
    dk)`` (≤ 0) and ``beta`` ``(B, S, H)``, from a zero state, in chunks
    of ``chunk`` tokens (the sequence padded at its end to a whole chunk;
    a shorter one is one chunk, padded to whole sub-chunks): ``o`` ``(B,
    S, H, dv)``, f32, ``o_t = S_tᵀ q_t / √dk``."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    c = min(chunk, s + (-s) % SUB)  # a short sequence: one chunk
    pad = (-s) % c
    n = (s + pad) // c

    def chunks(x):  # (B, S, H, ...) -> (B·H, N, C, ...), f32
        x = x.float()
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.reshape(b, n, c, h, *x.shape[3:]).movedim(3, 1)
        return x.reshape(b * h, *x.shape[2:])

    q, k, v, g, beta = map(chunks, (q * dk ** -0.5, k, v, g, beta))
    G = g.cumsum(dim=-2)  # within the chunk, ≤ 0, decreasing
    kk, m = _pairs([k, q], k, G, math.gcd(c, SUB))
    a = (kk * beta[..., :, None]).tril(-1)
    eye = torch.eye(c, dtype=a.dtype, device=a.device)
    t = torch.linalg.solve_triangular(eye + a, eye, upper=False,
                                      unitriangular=True) * beta[..., None, :]
    gam = torch.exp(G)
    u = t @ v  # (B·H, N, C, dv)
    wk = t @ (k * gam)  # (B·H, N, C, dk)
    k_end = (k * torch.exp(G[..., -1:, :] - G)).transpose(-1, -2)
    # a chunk takes S to F S + P: F = Diag(e^{G_C}) − (K e^{G_C − G})ᵀ
    # T (K e^G), P = (K e^{G_C − G})ᵀ T V, so that the loop across chunks
    # is one launch a chunk and the rest runs batched over the chunks
    trans = torch.diag_embed(torch.exp(G[..., -1, :])) - k_end @ wk
    gain = k_end @ u  # (B·H, N, dk, dv)
    state = v.new_zeros((b * h, dk, dv))
    states = []
    # unbound once: a chunk's slice then takes its gradient alone (an
    # index a chunk would add a whole-size zero tensor to it per chunk)
    for trans_i, gain_i in zip(trans.unbind(1), gain.unbind(1)):
        states.append(state)
        state = torch.baddbmm(gain_i, trans_i, state)
    s_in = torch.stack(states, 1)  # the state entering each chunk
    o = (q * gam) @ s_in + m @ (u - wk @ s_in)
    return o.view(b, h, n * c, dv).transpose(1, 2)[:, :s]


class KDAFn(torch.autograd.Function):
    """:func:`kda_chunked` as one autograd node: the forward keeps its
    inputs only; the backward runs the chunked form again under autograd
    and differentiates it. The f32 output; the gradients in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta, chunk: int):
        ctx.save_for_backward(q, k, v, g, beta)
        ctx.chunk = chunk
        return kda_chunked(q, k, v, g, beta, chunk)

    @staticmethod
    def backward(ctx, do):
        xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            o = kda_chunked(*xs, ctx.chunk)
        return (*torch.autograd.grad(o, xs, do), None)


def kda_block(p: KDA, x, cfg, positions=None, *, causal: bool = True,
              use_kernel: bool | None = None):
    """KDA over ``x`` (B, S, d), causal (``positions`` and ``use_kernel``
    are the attention blocks' arguments, unused: the rule has no
    positions and no kernel yet). The short convolutions, gates and
    norms in f32; the projections in the parameters' dtype. Counts a host
    ``kda.calls``."""
    if not causal:
        raise ValueError("Kimi Delta Attention is causal")
    tracing.add("kda.calls", 1)
    la = cfg.linear
    b, s, _ = x.shape
    heads = (b, s, la.n_heads, la.head_dim)

    def branch(w, taps):
        return F.silu(_causal_conv((x @ w).float(), taps.float())).view(heads)

    q, k = _l2norm(branch(p.wq, p.conv_q)), _l2norm(branch(p.wk, p.conv_k))
    v = branch(p.wv, p.conv_v)
    g = -torch.exp(p.A_log)[:, None] * F.softplus(
        ((x @ p.wf_a) @ p.wf_b).float().view(heads)
        + p.dt_bias.view(heads[2:]))
    beta = torch.sigmoid((x @ p.wb).float())
    o = KDAFn.apply(q, k, v, g, beta, CHUNK)
    gate = torch.sigmoid(((x @ p.wg_a) @ p.wg_b).float()).view(heads)
    o = rms_norm(o, p.o_norm, cfg.norm_eps) * gate
    return o.reshape(b, s, -1).to(x.dtype) @ p.wo
