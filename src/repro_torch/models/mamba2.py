"""Mamba2 (SSD) block (the port of the JAX package's ``models/mamba2.py``):
the chunked parallel scan for prefill, the O(1)-state recurrent step for
decode.

Chunked SSD (Dao & Gu 2024): within a chunk of length Q the output is a
masked quadratic form; across chunks a (heads, P, N) state carries the
recurrence:

  h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t  (x)  x_t)
  y_t = C_t . h_t + D * x_t

All cumulative products run in log space (dA <= 0). The reference computes
the SSD outside any Pallas kernel, so here it is plain torch on both
devices (``einsum``; the cross-chunk ``lax.scan`` is a loop over chunks),
and the projections are plain large products (docs/port.md §hybrid).

The decode step writes its new ``h`` and ``conv`` state in place, into
every batch row or only into ``rows``, as ``layers.decode_attention``
writes K/V.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _causal_conv, _param, normal_, rms_norm


def _dims(cfg) -> tuple[int, int, int]:
    """-> (d_in, n_heads, conv_ch)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.n_groups * s.state


class Mamba2(nn.Module):
    """One Mamba2 layer's parameters (``mamba2_init``): ``A_log``, ``D``
    and ``dt_bias`` in f32, the rest in the model dtype."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        s = cfg.ssm
        d_in, n_heads, conv_ch = _dims(cfg)
        dt, f32 = cfg.param_dtype, torch.float32
        self.in_proj = _param(
            (cfg.d_model, 2 * d_in + 2 * s.n_groups * s.state + n_heads),
            dt, device)
        self.conv_w = _param((s.conv, conv_ch), dt, device)
        self.conv_b = _param((conv_ch,), dt, device)
        self.A_log = _param((n_heads,), f32, device)
        self.D = _param((n_heads,), f32, device)
        self.dt_bias = _param((n_heads,), f32, device)
        self.norm = _param((d_in,), dt, device)
        self.out_proj = _param((d_in, cfg.d_model), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """The reference's distributions: projections N(0, 1/d_in), the
        conv taps N(0, 1/conv), ``A_log``, ``dt_bias`` and the conv bias
        zero, ``D`` and the norm one."""
        d_in = self.out_proj.shape[0]
        normal_(self.in_proj, 1.0 / math.sqrt(cfg.d_model), generator)
        normal_(self.conv_w, 1.0 / math.sqrt(cfg.ssm.conv), generator)
        normal_(self.out_proj, 1.0 / math.sqrt(d_in), generator)
        for w in (self.conv_b, self.A_log, self.dt_bias):
            w.zero_()
        self.D.fill_(1.0)
        self.norm.fill_(1.0)


def _split_zxbcdt(cfg, zxbcdt):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * gn]
    dt = zxbcdt[..., -(d_in // s.head_dim):]
    return z, xbc, dt


def _ssd_chunked(xh, dt, dA, Bm, Cm, s, h0=None):
    """Chunked SSD.

    xh: (B,S,H,P) inputs; dt: (B,S,H); dA: (B,S,H) = dt*A (<=0)
    Bm/Cm: (B,S,G,N); state h0: (B,H,P,N) or None.
    Returns y (B,S,H,P), h_final.
    """
    b, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(s.chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must tile by chunk {Q}")
    nc = S // Q
    rep = H // G

    def to_chunks(a):
        return a.reshape((b, nc, Q) + tuple(a.shape[2:]))

    xh, dt, dA, Bm, Cm = map(to_chunks, (xh, dt, dA, Bm, Cm))
    # broadcast groups to heads
    Bh = Bm.repeat_interleave(rep, dim=3) if rep > 1 else Bm  # (b,nc,Q,H,N)
    Ch = Cm.repeat_interleave(rep, dim=3) if rep > 1 else Cm

    cum = torch.cumsum(dA, dim=2)  # (b,nc,Q,H)
    # intra-chunk attention-like term: att[t,s] = exp(cum_t - cum_s), t>=s.
    # The mask goes on the exponent, not on exp's result: above the
    # diagonal cum_t - cum_s >= 0 overflows exp once a chunk's decay passes
    # ~88, and where's zero gradient times exp's inf there would be NaN in
    # the backward (the reference masks the result; its forward values are
    # the same)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,t,s,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    att = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                float("-inf")))
    # scores_{t,s} = (C_t . B_s) att u_s  with u_s = dt_s x_s
    cb = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh)  # (b,nc,t,s,H)
    u = xh * dt[..., None]  # (b,nc,Q,H,P)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", cb * att, u)

    # cross-chunk: scan the state
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,Q,H)
    chunk_state = torch.einsum("bcshn,bcshp->bchpn",
                               Bh * decay_out[..., None], u)
    chunk_gain = torch.exp(cum[:, :, -1, :])  # (b,nc,H)

    h = (h0 if h0 is not None
         else torch.zeros((b, H, P, N), dtype=torch.float32,
                          device=xh.device))
    h_prevs = []
    for c in range(nc):  # lax.scan -> a loop over chunks
        h_prevs.append(h)
        h = h * chunk_gain[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (b,nc,H,P,N)
    y_inter = torch.einsum("bcthn,bchpn->bcthp",
                           Ch * torch.exp(cum)[..., None], h_prevs)
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y, h


def mamba2_apply(p: Mamba2, x, cfg):
    """Train/prefill path. x: (B,S,d_model) -> (B,S,d_model)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    zxbcdt = x @ p.in_proj
    z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    gn = s.n_groups * s.state
    xs = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + gn]
    Cm = xbc[..., d_in + gn:]
    b, S, _ = x.shape
    xh = xs.reshape(b, S, H, s.head_dim).float()
    Bm = Bm.reshape(b, S, s.n_groups, s.state).float()
    Cm = Cm.reshape(b, S, s.n_groups, s.state).float()
    dtf = F.softplus(dt.float() + p.dt_bias)  # (B,S,H)
    A = -torch.exp(p.A_log)  # (H,)
    dA = dtf * A
    y, _ = _ssd_chunked(xh, dtf, dA, Bm, Cm, s)
    y = y + p.D[None, None, :, None] * xh
    y = y.reshape(b, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm)
    return y @ p.out_proj


# ---------------------------- decode ----------------------------


def mamba2_state_init(cfg, batch: int, device=None) -> dict:
    s = cfg.ssm
    _, H, conv_ch = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv - 1, conv_ch),
                            dtype=cfg.param_dtype, device=device),
    }


def mamba2_decode(p: Mamba2, x, cfg, state: dict, rows=None):
    """x: (B,1,d_model), one recurrent step -> (y, state).

    Writes the new ``h`` and ``conv`` into ``state`` in place: into every
    batch row (``rows=None``, the reference's step), or only into
    ``rows`` (an int64 index tensor on the state's device)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    zxbcdt = x @ p.in_proj
    z, xbc, dt = _split_zxbcdt(cfg, zxbcdt)
    # conv over the rolling buffer
    hist = torch.cat([state["conv"], xbc], dim=1)  # (B, conv, C)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(),
                            p.conv_w.float()) + p.conv_b.float()
    xbc1 = F.silu(conv_out)[:, None, :].to(x.dtype)
    gn = s.n_groups * s.state
    xs = xbc1[..., :d_in]
    Bm = xbc1[..., d_in:d_in + gn]
    Cm = xbc1[..., d_in + gn:]
    b = x.shape[0]
    xh = xs.reshape(b, H, s.head_dim).float()
    Bm = Bm.reshape(b, s.n_groups, s.state).float()
    Cm = Cm.reshape(b, s.n_groups, s.state).float()
    rep = H // s.n_groups
    Bh = Bm.repeat_interleave(rep, dim=1) if rep > 1 else Bm  # (b,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1) if rep > 1 else Cm
    dtf = F.softplus(dt[:, 0].float() + p.dt_bias)  # (B,H)
    alpha = torch.exp(dtf * -torch.exp(p.A_log))  # (B,H)
    u = xh * dtf[..., None]  # (b,H,P)
    h = state["h"] * alpha[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", u, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + p.D[None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm)
    if rows is None:
        state["h"].copy_(h)
        state["conv"].copy_(hist[:, 1:])
    else:
        state["h"][rows] = h[rows]
        state["conv"][rows] = hist[rows, 1:]
    return y @ p.out_proj, state
