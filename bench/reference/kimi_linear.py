"""Plain float32 reference of Kimi Linear's first training steps (moonshotai/
Kimi-Linear-48B-A3B-Instruct; the Kimi Linear report, arXiv:2510.26692):
Kimi Delta Attention (KDA) in three of every four layers, multi-head
latent attention without rotary embedding (NoPE) in the others, Kimi K2's
sigmoid-routed experts, in plain ``torch`` with no kernel, cache or
batching of the program.

It holds, for the configuration's dict (``bench/configs/<config>.json``),
what ``bench.reference.kimi_k2`` holds: :func:`leaf_specs` and
:func:`draw` (the parameter leaves, stacked by group: ``kda_layers`` and
``layers`` dense, ``kda_moe_layers`` and ``moe_layers`` with experts, the
KDA groups for the layers the published ``linear_attn_config`` names),
:func:`loss` and :func:`train`.

KDA, per layer, of x (width d), H heads of dk = dv = ``head_dim``:

  q = L2Norm(SiLU(ShortConv(x W_q))), k = L2Norm(SiLU(ShortConv(x W_k))),
  v = SiLU(ShortConv(x W_v))   (depthwise causal convolutions, no bias)
  g = −exp(A_log[h]) · softplus(x W_fa W_fb + dt_bias)    (log decay)
  β = sigmoid(x W_b)                                     (one a head)
  S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ
  o_t = S_tᵀ q_t / √dk
  out = W_o · concat_h(RMSNorm_h(o) ⊙ sigmoid(x W_ga W_gb))

:func:`kda_recurrent` is that recurrence token by token (the definition,
for the CPU tests); :func:`kda_chunked` the form this reference trains
with: chunks of :data:`CHUNK` tokens, each pair's decay exp(G_t − G_i)
taken whole (its mask on the exponent, so that no exponent is positive),
the UT transform's rows solved by ``torch.linalg.solve_triangular``, and
the state carried across chunks.

Multi-head latent attention without a query latent: q = x W_q per head,
[q_nope | q_pe]; a = x W_kva; c_kv = RMSNorm(a[:kv_rank]); k_pe =
a[kv_rank:], one per token, shared by the heads and, as q_pe, not rotated;
[k_nope | v] = c_kv W_kvb per head; softmax(q k^T / sqrt(192)) v, causal.

Every tensor is float32; matrix products run with TF32 off; with
``mode="fp8"`` every matrix product's inputs are rounded to float8, as
``bench.reference.mixtral`` rounds them (the control). Each layer is
recomputed in the backward, and the attention runs in blocks of queries.

Departures from the published model, each as the program under test runs
it (the configuration's ``assumed`` lists them): those of
``bench.reference.kimi_k2`` (the held slice of the experts, the
vocabulary's slice, the capacity, the selection bias drawn and not
trained, no auxiliary loss, weight decay on every leaf of two or more
dimensions of the stacked tree but the selection bias, bfloat16 storage);
and the weights of KDA drawn from the seed: ``A_log`` the log of U(1, 16)
a head and ``dt_bias`` softplus⁻¹ of a step log-uniform on [1e-3, 1e-1] a
channel (Mamba2's law), as leaves of float32; the L2 norm's epsilon
:data:`L2_EPS` under the root.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.kimi_k2 import BIAS_STD, Q_CHUNK, _attend, swiglu
from bench.reference.mixtral import (
    MATMUL,
    _adamw,
    leaf_seed,
    lr_at,
    no_tf32,
    rms_norm,
)
from bench.reference.mixtral import draw as _draw

#: What this reference computes, as fields of the program's architecture
#: configuration and of its experts' (the adapter holds the program to
#: them). The file's ``linear_attn_config`` gives KDA's heads, widths and
#: pattern, which this reference reads.
ARCH = {"family": "moe", "activation": "swiglu", "qkv_bias": False,
        "qk_norm": False, "use_rope": False, "tie_embeddings": False,
        "enc_dec": False, "n_frontend_tokens": 0, "d_ff": 9216,
        "q_rank": 0, "kv_rank": 512, "qk_nope_dim": 128, "qk_rope_dim": 64,
        "v_head_dim": 128, "norm_eps": 1e-5}
MOE = {"n_shared": 1, "moe_start_layer": 1, "score_func": "sigmoid",
       "route_scale": 2.446}

#: Tokens of a chunk of :func:`kda_chunked`.
CHUNK = 32

#: Heads whose chunks' decayed pairs are taken at a time (each block
#: recomputed in the backward, so that one block's (C, C, dk) decays live
#: at once).
HEAD_BLOCK = 8

#: The L2 norm's epsilon under the root (the published kernels').
L2_EPS = 1e-6


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _kda_numbers(cfg: dict) -> set:
    """The 1-based numbers of the layers that are KDA."""
    return set(cfg["linear_attn_config"]["kda_layers"])


def _groups(cfg: dict) -> list:
    """``(prefix, layer indices)`` of each group of stacked layers, in the
    order the layers first appear."""
    kda, dense = _kda_numbers(cfg), MOE["moe_start_layer"]
    out: dict = {}
    for i in range(cfg["n_layers"]):
        pre = (("kda_" if i + 1 in kda else "")
               + ("layers." if i < dense else "moe_layers."))
        out.setdefault(pre, []).append(i)
    return list(out.items())


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, dtype, law)`` of every parameter leaf: ``law`` is
    ``"ones"``, ``"a_log"``, ``"dt_bias"`` or the standard deviation of a
    normal law. Stacked leaves carry the layer axis first."""
    d, v, h = cfg["d_model"], cfg["vocab"], cfg["n_heads"]
    rkv, nope, rope_d, dv = (cfg[k] for k in (
        "kv_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim"))
    la = cfg["linear_attn_config"]
    kh, hd, kc = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    w = kh * hd
    moe = cfg["moe"]
    e, eh, f = moe["n_experts"], moe["n_held"], moe["d_ff"]
    fs = f * MOE["n_shared"]
    dt = getattr(torch, cfg["dtype"])
    rt = getattr(torch, cfg["router_dtype"])
    f32 = torch.float32
    out = [("embed", (v, d), dt, 0.02), ("ln_f", (d,), dt, "ones"),
           ("lm_head", (d, v), dt, d ** -0.5)]
    for pre, idx in _groups(cfg):
        n = len(idx)
        out += [(pre + "ln1", (n, d), dt, "ones"),
                (pre + "ln2", (n, d), dt, "ones")]
        a = pre + "attn."
        if pre.startswith("kda_"):
            out += [(a + "wq", (n, d, w), dt, d ** -0.5),
                    (a + "wk", (n, d, w), dt, d ** -0.5),
                    (a + "wv", (n, d, w), dt, d ** -0.5),
                    (a + "conv_q", (n, kc, w), dt, kc ** -0.5),
                    (a + "conv_k", (n, kc, w), dt, kc ** -0.5),
                    (a + "conv_v", (n, kc, w), dt, kc ** -0.5),
                    (a + "wf_a", (n, d, hd), dt, d ** -0.5),
                    (a + "wf_b", (n, hd, w), dt, hd ** -0.5),
                    (a + "A_log", (n, kh), f32, "a_log"),
                    (a + "dt_bias", (n, w), f32, "dt_bias"),
                    (a + "wb", (n, d, kh), dt, d ** -0.5),
                    (a + "wg_a", (n, d, hd), dt, d ** -0.5),
                    (a + "wg_b", (n, hd, w), dt, hd ** -0.5),
                    (a + "o_norm", (n, hd), dt, "ones"),
                    (a + "wo", (n, w, d), dt, w ** -0.5)]
        else:
            out += [(a + "wq", (n, d, h * (nope + rope_d)), dt, d ** -0.5),
                    (a + "wkv_a", (n, d, rkv + rope_d), dt, d ** -0.5),
                    (a + "kv_norm", (n, rkv), dt, "ones"),
                    (a + "wkv_b", (n, rkv, h * (nope + dv)), dt,
                     rkv ** -0.5),
                    (a + "wo", (n, h * dv, d), dt, (h * dv) ** -0.5)]
        if pre.endswith("moe_layers."):
            m = pre + "moe."
            out += [(m + "router", (n, d, e), rt, 0.02),
                    (m + "w_gate", (n, eh, d, f), dt, d ** -0.5),
                    (m + "w_up", (n, eh, d, f), dt, d ** -0.5),
                    (m + "w_down", (n, eh, f, d), dt, f ** -0.5),
                    (m + "shared.w_gate", (n, d, fs), dt, d ** -0.5),
                    (m + "shared.w_up", (n, d, fs), dt, d ** -0.5),
                    (m + "shared.w_down", (n, fs, d), dt, fs ** -0.5),
                    (m + "select_bias", (n, e), rt, BIAS_STD)]
        else:
            ff = cfg["d_ff"]
            out += [(pre + "mlp.w_gate", (n, d, ff), dt, d ** -0.5),
                    (pre + "mlp.w_up", (n, d, ff), dt, d ** -0.5),
                    (pre + "mlp.w_down", (n, ff, d), dt, ff ** -0.5)]
    return out


@torch.no_grad()
def draw(spec, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index``'s initial values as ``bench.reference.mixtral.draw``
    makes them, and KDA's two laws from a uniform draw of the leaf's own
    generator: ``"a_log"`` log(U(1, 16)), ``"dt_bias"`` softplus⁻¹ of
    exp(U(log 1e-3, log 1e-1)). A float32 tensor."""
    _, shape, dtype, law = spec
    if law not in ("a_log", "dt_bias"):
        return _draw(spec, seed, index, device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    u = torch.rand(shape, generator=gen, device=device)
    if law == "a_log":
        x = torch.log(1.0 + 15.0 * u)
    else:
        step = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                               - math.log(1e-3)))
        x = step + torch.log(-torch.expm1(-step))
    return x.to(dtype).float()


# --------------------------------------------------------------------------
# Kimi Delta Attention
# --------------------------------------------------------------------------


def kda_recurrent(q, k, v, g, beta):
    """The gated delta rule token by token, from a zero state: ``q``,
    ``k`` ``(B, S, H, dk)``, ``v`` ``(B, S, H, dv)``, the log decay ``g``
    ``(B, S, H, dk)``, ``beta`` ``(B, S, H)`` -> ``o`` ``(B, S, H, dv)``."""
    b, s, h, dk = k.shape
    scale = dk ** -0.5
    state = q.new_zeros((b, h, dk, v.shape[-1]))
    out = []
    for t in range(s):
        state = torch.exp(g[:, t])[..., None] * state
        kt, bt = k[:, t], beta[:, t, :, None]
        err = v[:, t] - torch.einsum("bhkv,bhk->bhv", state, kt)
        state = state + bt[..., None] * kt[..., None] * err[..., None, :]
        out.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t] * scale))
    return torch.stack(out, 1)


def _decayed_pairs(q, k, G, mm):
    """Σ_c k_tc k_ic D_tic and Σ_c q_tc k_ic D_tic, each ``(..., C, C)``,
    of a chunk's ``q``, ``k`` and cumulative log decay ``G`` ``(..., C,
    dk)``, with D_tic = exp(G_tc − G_ic) for i ≤ t, 0 above."""
    c = G.shape[-2]
    keep = torch.ones((c, c), dtype=torch.bool, device=G.device).tril()
    decay = torch.exp(torch.where(keep[:, :, None],
                                  G[..., :, None, :] - G[..., None, :, :],
                                  float("-inf")))  # (..., t, i, dk)
    kd = decay * k[..., None, :, :]
    return (mm(kd, k[..., :, :, None])[..., 0],
            mm(kd, q[..., :, :, None])[..., 0])


def kda_chunked(q, k, v, g, beta, mm=torch.matmul, chunk: int = CHUNK):
    """:func:`kda_recurrent` in chunks of ``chunk`` tokens (the sequence
    padded at its end): within a chunk, with G the cumulative log decay
    since its start and D[t, i] = exp(G_t − G_i) for i ≤ t (0 above;
    :data:`HEAD_BLOCK` heads at a time), A = tril_-1(β_t Σ_c k_tc k_ic D_tic) and the rows W of the UT
    transform solve (I + A) W = Diag(β) (V − (K ⊙ e^G) S), by
    ``torch.linalg.solve_triangular`` for V and for K ⊙ e^G; the output
    (Q ⊙ e^G) S + M W with M = Σ_c q_tc k_ic D_tic over i ≤ t; the state
    Diag(e^{G_C}) S + (K ⊙ e^{G_C − G})ᵀ W into the next chunk."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    n = (s + pad) // chunk

    def chunks(x):  # (B, S, H, ...) -> (B, H, N, C, ...)
        if pad:
            x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        return x.reshape(b, n, chunk, h, *x.shape[3:]).movedim(3, 1)

    q, k, v, g, beta = map(chunks, (q * dk ** -0.5, k, v, g, beta))
    G = g.cumsum(dim=3)
    blocks = [checkpoint(_decayed_pairs, q[:, h0:h0 + HEAD_BLOCK],
                         k[:, h0:h0 + HEAD_BLOCK], G[:, h0:h0 + HEAD_BLOCK],
                         mm, use_reentrant=False)
              for h0 in range(0, h, HEAD_BLOCK)]
    a = torch.cat([x for x, _ in blocks], 1) * beta[..., :, None]
    m = torch.cat([x for _, x in blocks], 1)
    unit = torch.eye(chunk, device=q.device) + a.tril(-1)
    rows_v = torch.linalg.solve_triangular(
        unit, beta[..., None] * v, upper=False, unitriangular=True)
    rows_k = torch.linalg.solve_triangular(
        unit, beta[..., None] * k * torch.exp(G), upper=False,
        unitriangular=True)
    k_end = (k * torch.exp(G[..., -1:, :] - G)).transpose(-1, -2)
    q_in = q * torch.exp(G)
    end = torch.exp(G[..., -1, :])[..., None]
    state = q.new_zeros((b * h, dk, dv))
    out = []
    for rv, rk, qc, mc, ec, kc in zip(*(x.flatten(0, 1).unbind(1) for x in (
            rows_v, rows_k, q_in, m, end, k_end))):
        w = rv - mm(rk, state)
        out.append(mm(qc, state) + mm(mc, w))
        state = ec * state + mm(kc, w)
    o = torch.stack(out, 1).reshape(b, h, n * chunk, dv)
    return o.transpose(1, 2)[:, :s]


def _l2norm(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def _short_conv(x, taps):
    """Depthwise causal convolution of ``x`` (B, S, C) with ``taps`` (K,
    C), the last tap on the current token, no bias."""
    kw = taps.shape[0]
    xp = F.pad(x, (0, 0, kw - 1, 0))
    return sum(xp[:, j:j + x.shape[1]] * taps[j] for j in range(kw))


def kda(p, pre, i, h, cfg, mm, rule=None):
    """KDA of layer ``i`` of group ``pre`` over ``h`` (B, S, d); ``rule``
    computes the delta rule from ``(q, k, v, g, beta)``
    (:func:`kda_chunked` through ``mm`` by default, or
    :func:`kda_recurrent` where the tests ask)."""
    b, s, _ = h.shape
    la = cfg["linear_attn_config"]
    heads = (b, s, la["num_heads"], la["head_dim"])
    w = {k: p[pre + "attn." + k][i] for k in (
        "wq", "wk", "wv", "conv_q", "conv_k", "conv_v", "wf_a", "wf_b",
        "A_log", "dt_bias", "wb", "wg_a", "wg_b", "o_norm", "wo")}

    def branch(name):
        return F.silu(_short_conv(mm(h, w["w" + name]),
                                  w["conv_" + name])).view(heads)

    q, k, v = _l2norm(branch("q")), _l2norm(branch("k")), branch("v")
    g = -torch.exp(w["A_log"])[:, None] * F.softplus(
        mm(mm(h, w["wf_a"]), w["wf_b"]).view(heads)
        + w["dt_bias"].view(heads[2:]))
    beta = torch.sigmoid(mm(h, w["wb"]))
    o = (rule or partial(kda_chunked, mm=mm))(q, k, v, g, beta)
    gate = torch.sigmoid(mm(mm(h, w["wg_a"]), w["wg_b"])).view(heads)
    o = rms_norm(o, w["o_norm"], cfg["norm_eps"]) * gate
    return mm(o.reshape(b, s, -1), w["wo"])


# --------------------------------------------------------------------------
# Multi-head latent attention without rotary embedding, and the experts
# --------------------------------------------------------------------------


def mla(p, pre, i, h, cfg, mm):
    """NoPE multi-head latent attention of layer ``i`` of group ``pre``
    over ``h`` (B, S, d), with the direct query projection."""
    b, s, _ = h.shape
    nh, rkv, nope = cfg["n_heads"], cfg["kv_rank"], cfg["qk_nope_dim"]
    w = {k: p[pre + "attn." + k][i] for k in (
        "wq", "wkv_a", "kv_norm", "wkv_b", "wo")}
    q = mm(h, w["wq"]).view(b, s, nh, -1).transpose(1, 2)
    a = mm(h, w["wkv_a"])
    ckv = rms_norm(a[..., :rkv], w["kv_norm"], cfg["norm_eps"])
    kv = mm(ckv, w["wkv_b"]).view(b, s, nh, -1).transpose(1, 2)
    k_pe = a[:, None, :, rkv:].expand(b, nh, s, cfg["qk_rope_dim"])
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    o = torch.cat([
        checkpoint(_attend, q[:, :, c0:c0 + Q_CHUNK],
                   k[:, :, :c0 + Q_CHUNK], v[:, :, :c0 + Q_CHUNK], c0, mm,
                   use_reentrant=False)
        for c0 in range(0, s, Q_CHUNK)], dim=2)
    return mm(o.transpose(1, 2).reshape(b, s, -1), w["wo"])


def route(xt, router, bias, cfg, mm):
    """The router's choice for the tokens ``xt`` (N, d): the gates, the
    chosen experts less ``held_start``, which assignments a held expert
    keeps under the capacity, and which are held (each ``(N, k)``)."""
    moe = cfg["moe"]
    k, e, eh = moe["top_k"], moe["n_experts"], moe["n_held"]
    scores = torch.sigmoid(mm(xt, router))
    _, idx = torch.topk(scores.detach() + bias.detach(), k, dim=-1)
    gates = scores.gather(-1, idx)
    gates = (gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
             * MOE["route_scale"])
    n = xt.shape[0]
    cap = int(max(k, moe["capacity_factor"] * n * k / e))
    local = idx - moe["held_start"]
    held = (local >= 0) & (local < eh)
    onehot = (F.one_hot(local.clamp(0, eh - 1).reshape(-1), eh)
              * held.reshape(-1, 1))
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return gates, local, held & (pos < cap).view(n, k), held


def experts(p, pre, i, h, cfg, mm):
    """The experts of layer ``i`` of group ``pre`` over ``h`` (B, S, d):
    the held experts' part and the shared expert's; and the held
    assignments dropped by the capacity."""
    b, s, d = h.shape
    xt = h.reshape(b * s, d)
    m = pre + "moe."
    gates, local, keep, held = route(xt, p[m + "router"][i],
                                     p[m + "select_bias"][i], cfg, mm)
    out = swiglu(xt, *(p[m + "shared." + w][i]
                       for w in ("w_gate", "w_up", "w_down")), mm)
    tok = torch.arange(b * s, device=h.device)[:, None].expand_as(local)
    for ex in range(cfg["moe"]["n_held"]):
        sel = (local == ex) & keep
        rows = tok[sel]
        if rows.numel() == 0:  # an expert no token chose adds nothing
            continue
        y = swiglu(xt[rows], *(p[m + w][i, ex]
                               for w in ("w_gate", "w_up", "w_down")), mm)
        out = out.index_add(0, rows, y * gates[sel][:, None])
    return out.view(b, s, d), (held & ~keep).sum()


def _layer(p, pre, i, x, cfg, mm, rule=None):
    """One decoder layer over ``x``; its dropped assignments."""
    eps = cfg["norm_eps"]
    h = rms_norm(x, p[pre + "ln1"][i], eps)
    x = x + (kda(p, pre, i, h, cfg, mm, rule) if pre.startswith("kda_")
             else mla(p, pre, i, h, cfg, mm))
    h = rms_norm(x, p[pre + "ln2"][i], eps)
    if pre.endswith("moe_layers."):
        y, drops = experts(p, pre, i, h, cfg, mm)
        return x + y, drops
    return x + swiglu(h, *(p[pre + "mlp." + w][i] for w in (
        "w_gate", "w_up", "w_down")), mm), torch.zeros(
            (), dtype=torch.int64, device=x.device)


def loss(p, batch, cfg, mm=torch.matmul, rule=None):
    """Mean cross-entropy of ``batch`` (``tokens``, ``labels``: (B, S)
    integers) under the parameters ``p`` (name → float32 leaf), and the
    held assignments dropped in all layers. The layers run in the model's
    order, each recomputed in the backward; ``rule`` as :func:`kda`'s."""
    if cfg["sliding_window"]:
        raise ValueError("the attention here is causal over the whole "
                         "sequence: sliding_window must be 0")
    where = {i: (pre, j) for pre, idx in _groups(cfg)
             for j, i in enumerate(idx)}
    x = p["embed"][batch["tokens"].long()]
    dropped = 0
    for i in range(cfg["n_layers"]):
        pre, j = where[i]
        x, drops = checkpoint(_layer, p, pre, j, x, cfg, mm, rule,
                              use_reentrant=False)
        dropped = dropped + drops
    logits = mm(rms_norm(x, p["ln_f"], cfg["norm_eps"]), p["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long()), dropped


# --------------------------------------------------------------------------
# Training steps
# --------------------------------------------------------------------------


def train(cfg: dict, seed: int, batches: list, device,
          mode: str = "f32") -> dict:
    """The configuration's training from the weights of ``seed`` over
    ``batches`` (one a step), in ``mode`` (``"f32"``, or ``"fp8"`` for the
    control). Returns ``loss`` (each step's), ``grad_norm`` (each leaf's
    gradient norm at the first step, before clipping), ``change_norm``
    (each leaf's ‖p − p0‖ after the last step) and ``dropped`` (each
    step's held assignments past the capacity), as Python numbers. The
    selection bias's gradient is 0 and it does not decay: it keeps its
    drawn value."""
    mm = MATMUL[mode]
    opt = cfg["optimizer"]
    b1, b2 = opt["b1"], opt["b2"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # what an earlier run left reserved
    specs = leaf_specs(cfg)
    p = {spec[0]: draw(spec, seed, i, device).requires_grad_()
         for i, spec in enumerate(specs)}
    m = {name: torch.zeros_like(x) for name, x in p.items()}
    v = {name: torch.zeros_like(x) for name, x in p.items()}
    losses, dropped, grad_norm = [], [], None
    with no_tf32():
        for step, batch in enumerate(batches):
            batch = {k: torch.as_tensor(x, device=device)
                     for k, x in batch.items()}
            value, drops = loss(p, batch, cfg, mm)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(p.values(), torch.autograd.grad(
                         value, list(p.values()), allow_unused=True))]
            losses.append(value.detach())
            dropped.append(drops)
            with torch.no_grad():
                norms = torch.stack([g.norm() for g in grads])
                if grad_norm is None:
                    grad_norm = norms
                gnorm = norms.square().sum().sqrt()
                scale = torch.clamp(opt["clip_norm"] / gnorm.clamp(min=1e-9),
                                    max=1.0)
                lr = lr_at(opt, step)
                bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                for j, (name, _, dtype, _) in enumerate(specs):
                    x, g = p[name], grads[j]
                    grads[j] = None
                    decay = x.dim() >= 2 and not name.endswith(
                        "select_bias")
                    # a stacked matrix a layer at a time: smaller temporaries
                    rows = range(x.shape[0]) if x.dim() >= 3 else [slice(None)]
                    for r in rows:
                        _adamw(opt, x[r], g[r] * scale, m[name][r],
                               v[name][r], lr, bc1, bc2, decay, dtype)
                    del g
        del m, v
        with torch.no_grad():
            change = torch.stack([
                (p[spec[0]] - draw(spec, seed, i, device)).norm()
                for i, spec in enumerate(specs)])
    names = [spec[0] for spec in specs]
    return {"loss": torch.stack(losses).tolist(),
            "grad_norm": dict(zip(names, grad_norm.tolist())),
            "change_norm": dict(zip(names, change.tolist())),
            "dropped": [int(x) for x in torch.stack(
                [torch.as_tensor(x) for x in dropped]).tolist()]}
