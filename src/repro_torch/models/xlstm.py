"""xLSTM blocks (the port of the JAX package's ``models/xlstm.py``):
chunked-parallel mLSTM (matrix memory) and recurrent sLSTM (scalar
memory), per Beck et al. 2024.

mLSTM state:  C (B,H,dk,dv), n (B,H,dk), m (B,H)   [exp-gate stabilizer]
  C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
  h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t))
Training/prefill runs chunkwise (log-space gate cumsums + carried state),
decode runs the recurrence directly.

sLSTM is a strict recurrence over time with per-head recurrent weights.

The reference computes both cells outside any Pallas kernel, so here they
are plain torch on both devices. The reference's cross-chunk
``lax.scan`` becomes two loops over chunks: the stabiliser ``m`` first
(its recurrence reads no ``C`` or ``n``), then the carried ``C`` and
``n``; everything inside a chunk runs batched over all chunks, as the
port's Mamba2 SSD does. The sLSTM time scan is a loop over positions,
its per-head recurrent product one block-diagonal ``addmm`` a step.
mLSTM's ``m`` starts at ``-inf``: the order of operations is the
reference's, so the first chunk's inter-chunk weights and carried-state
gain are ``exp(-inf) = 0``, never ``exp(-inf - (-inf))``, forward and
backward (docs/port.md §ssm).

The decode steps write their new state in place, into every batch row or
only into ``rows``, as ``mamba2_decode`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _param, normal_, rms_norm

# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


class MLSTMBlock(nn.Module):
    """One mLSTM block's parameters (``mlstm_init``): the up-projection to
    ``2 * d_in`` (cell input and gate ``z``), the 4-tap causal conv,
    q/k/v, the input and forget gate projection, the output norm and the
    down-projection; ``d_in = 2 * d_model``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = 2 * d
        dt = cfg.param_dtype
        self.ln = _param((d,), dt, device)
        self.w_in = _param((d, 2 * d_in), dt, device)
        self.conv_w = _param((4, d_in), dt, device)
        self.conv_b = _param((d_in,), dt, device)
        self.wq = _param((d_in, d_in), dt, device)
        self.wk = _param((d_in, d_in), dt, device)
        self.wv = _param((d_in, d_in), dt, device)
        self.w_if = _param((d_in, 2 * cfg.n_heads), dt, device)
        self.norm = _param((d_in,), dt, device)
        self.w_down = _param((d_in, d), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        """The reference's distributions: projections N(0, 1/d_in), the
        gates N(0, 0.02²), the conv taps N(0, 0.25), norms one, the conv
        bias zero."""
        d_in = 2 * cfg.d_model
        self.ln.fill_(1.0)
        normal_(self.w_in, 1.0 / math.sqrt(cfg.d_model), generator)
        normal_(self.conv_w, 0.5, generator)
        self.conv_b.zero_()
        for w in (self.wq, self.wk, self.wv):
            normal_(w, 1.0 / math.sqrt(d_in), generator)
        normal_(self.w_if, 0.02, generator)
        self.norm.fill_(1.0)
        normal_(self.w_down, 1.0 / math.sqrt(d_in), generator)


def _conv4(x, w, b):
    out = x * w[3]
    for j in range(1, 4):
        pad = torch.zeros_like(x[:, :j])
        out = out + torch.cat([pad, x[:, :-j]], dim=1) * w[3 - j]
    return out + b


def _mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int, state=None):
    """q/k/v: (B,S,H,D) f32; i_raw/f_raw: (B,S,H). Returns (h, state)."""
    b, S, H, D = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must tile by chunk {Q}")
    nc = S // Q
    scale = D ** -0.5

    def ch(a):
        return a.reshape((b, nc, Q) + tuple(a.shape[2:]))

    q, k, v, i_raw, f_raw = map(ch, (q, k, v, i_raw, f_raw))
    logf = F.logsigmoid(f_raw)  # (b,nc,Q,H)
    cumf = torch.cumsum(logf, dim=2)  # inclusive

    # intra-chunk logD[t,s] = cumf_t - cumf_s + i_s  (s <= t)
    diff = cumf[:, :, :, None, :] - cumf[:, :, None, :, :]
    logD = diff + i_raw[:, :, None, :, :]  # (b,nc,t,s,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    logD = torch.where(tri[None, None, :, :, None], logD, -math.inf)
    m_intra = logD.amax(dim=3)  # (b,nc,t,H)

    if state is None:
        C = torch.zeros((b, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, H, D), dtype=torch.float32, device=q.device)
        m_run = torch.full((b, H), -math.inf, device=q.device)
    else:
        C, n, m_run = state["C"], state["n"], state["m"]

    # The chunk-end stabiliser m_new = max(f_all + m_run, max_s(f_all -
    # cumf_s + i_s)) reads no C or n: its loop runs first, on (b, H).
    f_all = cumf[:, :, -1]  # (b,nc,H)
    tail = f_all[:, :, None, :] - cumf + i_raw  # (b,nc,s,H)
    tail_max = tail.amax(dim=2)
    m_prev, m_new = [], []
    for c in range(nc):
        m_prev.append(m_run)
        m_run = torch.maximum(f_all[:, c] + m_run, tail_max[:, c])
        m_new.append(m_run)
    m_prev = torch.stack(m_prev, dim=1)  # (b,nc,H)
    m_new = torch.stack(m_new, dim=1)

    # stabilizer per position: vs carried state decayed to t
    m_inter = cumf + m_prev[:, :, None, :]  # (b,nc,Q,H)
    m_t = torch.maximum(m_intra, m_inter)
    m_t = torch.clamp(m_t, min=-1e30)  # keep finite
    w_intra = torch.exp(logD - m_t[:, :, :, None, :])  # (b,nc,t,s,H)
    w_inter = torch.exp(m_inter - m_t)  # (b,nc,t,H)
    qk = torch.einsum("bctHd,bcsHd->bctsH", q, k) * scale
    # qk * w_intra first: the reference's three-operand einsum would
    # hold a (b, t, s, H, D) temporary
    a = qk * w_intra
    num = torch.einsum("bctsH,bcsHd->bctHd", a, v)
    den = a.sum(dim=3)

    # chunk-end state update, the carried (C, n) entering each chunk
    decay_s = torch.exp(tail - m_new[:, :, None, :])  # (b,nc,s,H)
    gain = torch.exp(f_all + m_prev - m_new)  # (b,nc,H)
    dk = decay_s[..., None] * k
    kv = torch.einsum("bcsHk,bcsHd->bcHkd", dk, v)
    kn = dk.sum(dim=2)  # (b,nc,H,D)
    C_prev, n_prev = [], []
    for c in range(nc):
        C_prev.append(C)
        n_prev.append(n)
        C = C * gain[:, c, :, None, None] + kv[:, c]
        n = n * gain[:, c, :, None] + kn[:, c]
    C_prev = torch.stack(C_prev, dim=1)  # (b,nc,H,D,D)
    n_prev = torch.stack(n_prev, dim=1)

    qi = q * w_inter[..., None]
    num = num + torch.einsum("bctHk,bcHkd->bctHd", qi, C_prev) * scale
    den = den + torch.einsum("bctHk,bcHk->bctH", qi, n_prev) * scale
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    return h.reshape(b, S, H, D), {"C": C, "n": n, "m": m_run}


def _mlstm_qkv_gates(p: MLSTMBlock, xc, xm, cfg, shape):
    """q, k, v reshaped to ``shape + (H, D)`` and the raw input and forget
    gates ``(..., H)``, all f32."""
    H = cfg.n_heads
    D = 2 * cfg.d_model // H
    q = (xc @ p.wq).reshape(shape + (H, D)).float()
    k = (xc @ p.wk).reshape(shape + (H, D)).float()
    v = (xm @ p.wv).reshape(shape + (H, D)).float()
    if_g = (xc @ p.w_if).float()
    return q, k, v, if_g[..., :H], if_g[..., H:]


def mlstm_block_apply(p: MLSTMBlock, x, cfg, state=None,
                      return_state: bool = False):
    d_in = 2 * cfg.d_model
    h_in = rms_norm(x, p.ln)
    xp = h_in @ p.w_in
    xm, z = xp[..., :d_in], xp[..., d_in:]
    xc = F.silu(_conv4(xm, p.conv_w, p.conv_b))
    b, S, _ = x.shape
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(p, xc, xm, cfg, (b, S))
    hh, new_state = _mlstm_chunked(q, k, v, i_raw, f_raw, cfg.ssm.chunk,
                                   state)
    hh = hh.reshape(b, S, d_in).to(x.dtype)
    out = rms_norm(hh, p.norm) * F.silu(z)
    out = x + out @ p.w_down
    return (out, new_state) if return_state else out


def mlstm_state_init(cfg, batch: int, device=None) -> dict:
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    D = d_in // H
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, D, D), dtype=f32, device=device),
        "n": torch.zeros((batch, H, D), dtype=f32, device=device),
        "m": torch.full((batch, H), -math.inf, dtype=f32, device=device),
        "conv": torch.zeros((batch, 3, d_in), dtype=cfg.param_dtype,
                            device=device),
    }


def _write(state: dict, new: dict, rows) -> None:
    """``new`` into ``state`` in place: every batch row, or ``rows``."""
    for name, x in new.items():
        if rows is None:
            state[name].copy_(x)
        else:
            state[name][rows] = x[rows]


def mlstm_block_decode(p: MLSTMBlock, x, cfg, state: dict, rows=None):
    """x: (B,1,d). Recurrent mLSTM step -> (y, state), the new state
    written into ``state`` (every row, or ``rows``)."""
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    D = d_in // H
    h_in = rms_norm(x, p.ln)
    xp = h_in @ p.w_in
    xm, z = xp[..., :d_in], xp[..., d_in:]
    hist = torch.cat([state["conv"], xm], dim=1)  # (B,4,d_in)
    xc = F.silu(
        torch.einsum("bkc,kc->bc", hist.float(), p.conv_w.float())
        + p.conv_b.float()
    )[:, None].to(x.dtype)
    b = x.shape[0]
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(p, xc, xm, cfg, (b,))
    i_raw, f_raw = i_raw[:, 0], f_raw[:, 0]
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + state["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    C = state["C"] * f_s[..., None, None] + torch.einsum(
        "bHk,bHd->bHkd", i_s[..., None] * k, v)
    n = state["n"] * f_s[..., None] + i_s[..., None] * k
    scale = D ** -0.5
    num = torch.einsum("bHk,bHkd->bHd", q, C) * scale
    den = torch.einsum("bHk,bHk->bH", q, n) * scale
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    hh = h.reshape(b, 1, d_in).to(x.dtype)
    out = rms_norm(hh, p.norm) * F.silu(z)
    _write(state, {"C": C, "n": n, "m": m_new, "conv": hist[:, 1:]}, rows)
    return x + out @ p.w_down, state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


class SLSTMBlock(nn.Module):
    """One sLSTM block's parameters (``slstm_init``): the input path to
    the four gates ``z, i, f, o``, the per-head recurrent weights
    ``(H, dh, 4 dh)`` and the output projection."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg.d_model
        H = cfg.n_heads
        dh = d // H
        dt = cfg.param_dtype
        self.ln = _param((d,), dt, device)
        self.w_zifo = _param((d, 4 * d), dt, device)
        self.r_zifo = _param((H, dh, 4 * dh), dt, device)
        self.w_out = _param((d, d), dt, device)

    @torch.no_grad()
    def init_weights(self, cfg, generator: torch.Generator) -> None:
        d = cfg.d_model
        self.ln.fill_(1.0)
        normal_(self.w_zifo, 1.0 / math.sqrt(d), generator)
        normal_(self.r_zifo, 1.0 / math.sqrt(self.r_zifo.shape[1]),
                generator)
        normal_(self.w_out, 1.0 / math.sqrt(d), generator)


def slstm_state_init(cfg, batch: int, device=None) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.ones((batch, d), dtype=f32, device=device),
        "m": torch.zeros((batch, d), dtype=f32, device=device),
        "h": torch.zeros((batch, d), dtype=f32, device=device),
    }


def _recurrent(p: SLSTMBlock) -> torch.Tensor:
    """The per-head recurrent weights ``(H, dh, 4 dh)`` as one f32
    block-diagonal ``(d, 4d)`` matrix: ``h @ R`` is the reference's
    ``einsum("bHk,Hkf->bHf")`` reshaped to ``(b, 4d)``, in one product."""
    return torch.block_diag(*p.r_zifo.float())


def _slstm_cell(r_zifo, cfg, zifo_x, state):
    """zifo_x: (B, 4d) pre-activations from the input path; ``r_zifo``
    the recurrent weights of :func:`_recurrent`. The reference's
    operations, a dozen launches a step: the recurrent product and the
    input added in one ``addmm``, ``fr + m`` formed once."""
    zifo = torch.addmm(zifo_x, state["h"], r_zifo)
    zr, ir, fr, orr = torch.chunk(zifo, 4, dim=-1)
    fm = fr + state["m"]
    m_new = torch.maximum(fm, ir)
    i_g = torch.exp(ir - m_new)
    f_g = torch.exp(fm - m_new)
    c = torch.addcmul(f_g * state["c"], i_g, torch.tanh(zr))
    n = torch.addcmul(i_g, f_g, state["n"])
    h = torch.sigmoid(orr) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}


def slstm_block_apply(p: SLSTMBlock, x, cfg, state=None,
                      return_state: bool = False):
    b, S, d = x.shape
    h_in = rms_norm(x, p.ln)
    # (S, B, 4d): each position's pre-activations contiguous
    zifo_x = (h_in @ p.w_zifo).float().transpose(0, 1).contiguous()
    st = state or slstm_state_init(cfg, b, x.device)
    r_zifo = _recurrent(p)
    hs = []
    for t in range(S):  # lax.scan over time -> a loop over positions
        st = _slstm_cell(r_zifo, cfg, zifo_x[t], st)
        hs.append(st["h"])
    hs = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,d)
    out = x + hs @ p.w_out
    return (out, st) if return_state else out


def slstm_block_decode(p: SLSTMBlock, x, cfg, state: dict, rows=None):
    """x: (B,1,d). One sLSTM step -> (y, state), the new state written
    into ``state`` (every row, or ``rows``)."""
    h_in = rms_norm(x, p.ln)
    zifo_x = (h_in[:, 0] @ p.w_zifo).float()
    new = _slstm_cell(_recurrent(p), cfg, zifo_x, state)
    out = x + new["h"][:, None].to(x.dtype) @ p.w_out
    _write(state, new, rows)
    return out, state
