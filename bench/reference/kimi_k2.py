"""Plain float32 reference of Kimi K2's first training steps (moonshotai/
Kimi-K2-Instruct: DeepSeek-V3's block; the attention is DeepSeek-V2's
multi-head latent attention, arXiv:2405.04434 §2.1.2-2.1.3), in plain
``torch`` with no kernel, cache or batching of the program.

It holds, for the configuration's dict (``bench/configs/<config>.json``):

- :func:`leaf_specs`, the parameter leaves (names, shapes, stored dtypes,
  initial laws), stacked over the layers (the dense ``layers`` first,
  then ``moe_layers``), and :func:`draw`, the weights the benchmark makes
  from a seed, on the device, one leaf a call (``bench.reference.mixtral``'s
  law): the same values go to the program and to this reference;
- :func:`loss`, the forward pass: embedding; per layer RMSNorm, multi-head
  latent attention (causal), the residual, RMSNorm, then the dense SwiGLU
  (the first ``moe_start_layer`` layers) or the mixture of experts:
  sigmoid scores of the f32 router over all ``n_experts``, the top k of
  score plus the selection bias chosen, the k scores renormalised and
  times ``route_scale``, the held experts' SwiGLU under the capacity rule
  and the shared expert; final RMSNorm, the head over the vocabulary's
  slice and the mean cross-entropy;
- :func:`train`, the configuration's AdamW over the given batches, with
  the gradients by autograd, returning what the benchmark compares.

Multi-head latent attention, per layer, of x (width d), H heads:
c_q = RMSNorm(x W_qa); [q_nope | q_pe] = c_q W_qb per head, q_pe roped;
a = x W_kva; c_kv = RMSNorm(a[:kv_rank]); k_pe = rope(a[kv_rank:]), one
per token, shared by the heads; [k_nope | v] = c_kv W_kvb per head;
q = [q_nope | q_pe], k = [k_nope | k_pe]; o_h = softmax(q_h k_h^T /
sqrt(qk_nope + qk_rope), causal) v_h; out = concat_h(o_h) W_o.

Every tensor is float32. Matrix products run with TF32 off. With
``mode="fp8"`` every matrix product's inputs are rounded to float8 (e4m3
forward, e5m2 for the gradients, each tensor scaled to its largest
magnitude): the control, a precision below the configuration's bfloat16.
It is computed in blocks so that it fits on the card beside its own f32
state and AdamW moments: each layer is recomputed in the backward
(``torch.utils.checkpoint``), and the attention runs a block of
:data:`Q_CHUNK` queries at a time against the keys it reaches, each
block recomputed in the backward too.

Departures from the published model, each as the program under test runs
it (the configuration's ``assumed`` lists them):

- the card holds experts ``[held_start, held_start + n_held)`` of the
  router's ``n_experts`` (one card's shard of expert parallelism); an
  assignment to an absent expert adds nothing and takes no capacity, and
  the vocabulary is a slice (``vocab``), from which the tokens are drawn;
- each held expert takes at most ``cap = int(max(k, cf · N · k / E))`` of
  the step's assignments to it, counted in token-major order; an
  assignment past the capacity contributes nothing. The published model
  drops nothing;
- rotary embedding rotates interleaved pairs at ``rope_theta``, without
  the published YaRN scaling of the frequencies and of the softmax scale;
- the selection bias is drawn from the seed and is a leaf of the tree
  that nothing trains: its gradient is 0 (it moves the choice, not the
  gates) and weight decay passes it by, so it keeps its drawn value; the
  aux-free balancing update and the sequence-wise auxiliary loss are
  left out;
- weight decay applies to every other leaf of two or more dimensions in
  the stacked tree, and parameters are stored in their stated dtype
  after every update (bfloat16; the router and the selection bias
  float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.mixtral import (
    MATMUL,
    _adamw,
    draw,
    lr_at,
    no_tf32,
    rms_norm,
    rope,
)

#: What this reference computes, as fields of the program's architecture
#: configuration and of its experts' (the adapter holds the program to
#: them): a decoder of pre-norm layers with multi-head latent attention,
#: a dense SwiGLU first layer, untied head, no biases, at Kimi K2's
#: published widths. The configuration's file gives the same widths
#: (``d_ff``, ``q_rank``, ``kv_rank``, ``qk_nope_dim``, ``qk_rope_dim``,
#: ``v_head_dim``), which this reference reads; the tests give smaller
#: ones.
ARCH = {"family": "moe", "activation": "swiglu", "qkv_bias": False,
        "qk_norm": False, "use_rope": True, "tie_embeddings": False,
        "enc_dec": False, "n_frontend_tokens": 0, "d_ff": 18432,
        "q_rank": 1536, "kv_rank": 512, "qk_nope_dim": 128,
        "qk_rope_dim": 64, "v_head_dim": 128}
MOE = {"n_shared": 1, "moe_start_layer": 1, "score_func": "sigmoid",
       "route_scale": 2.827}

#: Queries of one attention block.
Q_CHUNK = 512

#: Standard deviation of the drawn selection bias: of the order of the
#: gaps between a token's top sigmoid scores, so that it moves the choice
#: at the margin of the top k.
BIAS_STD = 0.01


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def _groups(cfg: dict) -> list:
    """``(prefix, layers)`` of the dense and the expert layers."""
    dense = MOE["moe_start_layer"]
    return [("layers.", dense), ("moe_layers.", cfg["n_layers"] - dense)]


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, dtype, law)`` of every parameter leaf: ``law`` is
    ``"ones"`` or the standard deviation of a normal law. Stacked leaves
    carry the layer axis first."""
    d, v, h = cfg["d_model"], cfg["vocab"], cfg["n_heads"]
    rq, rkv, nope, rope_d, dv = (cfg[k] for k in (
        "q_rank", "kv_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim"))
    moe = cfg["moe"]
    e, eh, f = moe["n_experts"], moe["n_held"], moe["d_ff"]
    fs = f * MOE["n_shared"]
    dt = getattr(torch, cfg["dtype"])
    rt = getattr(torch, cfg["router_dtype"])
    out = [("embed", (v, d), dt, 0.02), ("ln_f", (d,), dt, "ones"),
           ("lm_head", (d, v), dt, d ** -0.5)]
    for pre, n in _groups(cfg):
        out += [
            (pre + "ln1", (n, d), dt, "ones"),
            (pre + "ln2", (n, d), dt, "ones"),
            (pre + "attn.wq_a", (n, d, rq), dt, d ** -0.5),
            (pre + "attn.q_norm", (n, rq), dt, "ones"),
            (pre + "attn.wq_b", (n, rq, h * (nope + rope_d)), dt, rq ** -0.5),
            (pre + "attn.wkv_a", (n, d, rkv + rope_d), dt, d ** -0.5),
            (pre + "attn.kv_norm", (n, rkv), dt, "ones"),
            (pre + "attn.wkv_b", (n, rkv, h * (nope + dv)), dt, rkv ** -0.5),
            (pre + "attn.wo", (n, h * dv, d), dt, (h * dv) ** -0.5),
        ]
        if pre == "layers.":
            ff = cfg["d_ff"]
            out += [(pre + "mlp.w_gate", (n, d, ff), dt, d ** -0.5),
                    (pre + "mlp.w_up", (n, d, ff), dt, d ** -0.5),
                    (pre + "mlp.w_down", (n, ff, d), dt, ff ** -0.5)]
        else:
            m = pre + "moe."
            out += [
                (m + "router", (n, d, e), rt, 0.02),
                (m + "w_gate", (n, eh, d, f), dt, d ** -0.5),
                (m + "w_up", (n, eh, d, f), dt, d ** -0.5),
                (m + "w_down", (n, eh, f, d), dt, f ** -0.5),
                (m + "shared.w_gate", (n, d, fs), dt, d ** -0.5),
                (m + "shared.w_up", (n, d, fs), dt, d ** -0.5),
                (m + "shared.w_down", (n, fs, d), dt, fs ** -0.5),
                (m + "select_bias", (n, e), rt, BIAS_STD),
            ]
    return out


# --------------------------------------------------------------------------
# Forward pass and loss
# --------------------------------------------------------------------------


def _attend(q, k, v, q0: int, mm):
    """Softmax attention of the queries ``q`` (B, H, C, D) at positions
    ``q0 …`` over the keys ``k`` (B, H, Sk, D) at ``0 …``, causal, and
    their values ``v``."""
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    qi = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s.masked_fill(ki > qi, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def attention(p, pre, i, h, cfg, mm):
    """Multi-head latent attention of layer ``i`` of group ``pre`` over
    ``h`` (B, S, d)."""
    b, s, _ = h.shape
    nh, eps, theta = cfg["n_heads"], cfg["norm_eps"], cfg["rope_theta"]
    rkv, nope, rope_d = cfg["kv_rank"], cfg["qk_nope_dim"], cfg["qk_rope_dim"]
    w = {k: p[pre + "attn." + k][i] for k in (
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")}
    cq = rms_norm(mm(h, w["wq_a"]), w["q_norm"], eps)
    q = mm(cq, w["wq_b"]).view(b, s, nh, -1).transpose(1, 2)
    a = mm(h, w["wkv_a"])
    ckv = rms_norm(a[..., :rkv], w["kv_norm"], eps)
    k_pe = rope(a[:, None, :, rkv:], theta)  # (B, 1, S, rope)
    kv = mm(ckv, w["wkv_b"]).view(b, s, nh, -1).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, nh, s, rope_d)], dim=-1)
    v = kv[..., nope:]
    o = torch.cat([
        checkpoint(_attend, q[:, :, c0:c0 + Q_CHUNK],
                   k[:, :, :c0 + Q_CHUNK], v[:, :, :c0 + Q_CHUNK], c0, mm,
                   use_reentrant=False)
        for c0 in range(0, s, Q_CHUNK)], dim=2)
    return mm(o.transpose(1, 2).reshape(b, s, -1), w["wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def route(xt, router, bias, cfg, mm):
    """The router's choice for the tokens ``xt`` (N, d): the gates, the
    chosen experts less ``held_start``, and which assignments a held
    expert keeps under the capacity (each ``(N, k)``)."""
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


def experts(p, i, h, cfg, mm):
    """Expert layer ``i``'s output over ``h`` (B, S, d): the held experts'
    part and the shared expert's; and the held assignments dropped by the
    capacity."""
    b, s, d = h.shape
    xt = h.reshape(b * s, d)
    pre = "moe_layers.moe."
    gates, local, keep, held = route(xt, p[pre + "router"][i],
                                     p[pre + "select_bias"][i], cfg, mm)
    out = swiglu(xt, *(p[pre + "shared." + w][i]
                       for w in ("w_gate", "w_up", "w_down")), mm)
    tok = torch.arange(b * s, device=h.device)[:, None].expand_as(local)
    for ex in range(cfg["moe"]["n_held"]):
        sel = (local == ex) & keep
        rows = tok[sel]
        if rows.numel() == 0:  # an expert no token chose adds nothing
            continue
        y = swiglu(xt[rows], *(p[pre + w][i, ex]
                               for w in ("w_gate", "w_up", "w_down")), mm)
        out = out.index_add(0, rows, y * gates[sel][:, None])
    return out.view(b, s, d), (held & ~keep).sum()


def _layer(p, pre, i, x, cfg, mm):
    """One decoder layer (dense or expert) over ``x``; its dropped
    assignments."""
    eps = cfg["norm_eps"]
    x = x + attention(p, pre, i, rms_norm(x, p[pre + "ln1"][i], eps), cfg,
                      mm)
    h = rms_norm(x, p[pre + "ln2"][i], eps)
    if pre == "layers.":
        return x + swiglu(h, *(p[pre + "mlp." + w][i] for w in (
            "w_gate", "w_up", "w_down")), mm), torch.zeros(
                (), dtype=torch.int64, device=x.device)
    y, drops = experts(p, i, h, cfg, mm)
    return x + y, drops


def loss(p, batch, cfg, mm=torch.matmul):
    """Mean cross-entropy of ``batch`` (``tokens``, ``labels``: (B, S)
    integers) under the parameters ``p`` (name → float32 leaf), and the
    held assignments dropped in all layers. Each layer is recomputed in
    the backward."""
    if cfg["sliding_window"]:
        raise ValueError("multi-head latent attention here is causal over "
                         "the whole sequence: sliding_window must be 0")
    x = p["embed"][batch["tokens"].long()]
    dropped = 0
    for pre, n in _groups(cfg):
        for i in range(n):
            x, drops = checkpoint(_layer, p, pre, i, x, cfg, mm,
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
