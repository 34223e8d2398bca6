"""Plain float32 reference of a Mixtral-style sparse-MoE decoder's first
training steps (Jiang et al. 2024, "Mixtral of Experts", arXiv:2401.04088),
in plain ``torch`` with no kernel, cache or batching of the program.

It holds, for the configuration's dict (``bench/configs/<config>.json``):

- :func:`leaf_specs`, the parameter leaves (names, shapes, stored dtypes,
  initial laws), stacked over the layers, and :func:`draw`, the weights
  the benchmark makes from a seed, on the device, one leaf a call: the
  same values go to the program and to this reference;
- :func:`loss`, the forward pass: embedding; per layer RMSNorm, rotary
  embedding, grouped-query attention (causal, sliding window), the
  residual, RMSNorm, the f32 router's softmax, top-k experts with their
  gates renormalised, SwiGLU experts under the capacity rule; final
  RMSNorm, the head and the mean cross-entropy;
- :func:`train`, the configuration's AdamW over the given batches, with
  the gradients by autograd, returning what the benchmark compares.

Every tensor is float32. Matrix products run with TF32 off. With
``mode="fp8"`` every matrix product's inputs are rounded to float8 (e4m3
forward, e5m2 for the gradients, each tensor scaled to its largest
magnitude): the control, a precision below the configuration's bfloat16.

Departures from the published model, each as the program under test runs
it (the configuration's ``assumed`` lists them):

- rotary embedding rotates interleaved pairs ``(x[2i], x[2i+1])``, not
  the two halves: for random weights the same law up to a fixed
  permutation of the q and k columns; ``rope_theta`` and ``norm_eps`` are
  the configuration's;
- each expert holds at most ``cap = int(max(k, cf · N · k / E))`` of the
  ``N · k`` assignments of a step (``capacity_factor`` cf), counted in
  token-major order (a token's first choice before its second, token by
  token); an assignment past the capacity contributes nothing. The
  published model drops nothing;
- weight decay applies to every leaf of two or more dimensions in the
  stacked tree, the layers' (L, d) norm scales included, and parameters
  are stored in their stated dtype after every update (bfloat16; the
  router float32): an update smaller than half a unit in the last place
  leaves an element where it was.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

#: What this reference computes, as fields of the program's architecture
#: configuration and of its experts' (the adapter holds the program to
#: them): a decoder of pre-norm SwiGLU-expert layers only, untied head,
#: rotary embedding, no biases, no q/k norm, no shared expert.
ARCH = {"family": "moe", "activation": "swiglu", "qkv_bias": False,
        "qk_norm": False, "use_rope": True, "tie_embeddings": False,
        "enc_dec": False, "n_frontend_tokens": 0}
MOE = {"n_shared": 0, "moe_start_layer": 0}

#: The largest finite magnitudes of the float8 formats.
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


# --------------------------------------------------------------------------
# Parameters and the weights made from the seed
# --------------------------------------------------------------------------


def leaf_specs(cfg: dict) -> list:
    """``(name, shape, dtype, law)`` of every parameter leaf: ``law`` is
    ``"ones"`` or the standard deviation of a normal law. Stacked leaves
    carry the layer axis first."""
    d, v, n = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    hd = cfg["head_dim"]
    hq, hkv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    moe = cfg["moe"]
    e, f = moe["n_experts"], moe["d_ff"]
    dt = getattr(torch, cfg["dtype"])
    rt = getattr(torch, cfg["router_dtype"])
    lay = "moe_layers."
    return [
        ("embed", (v, d), dt, 0.02),
        ("ln_f", (d,), dt, "ones"),
        ("lm_head", (d, v), dt, d ** -0.5),
        (lay + "ln1", (n, d), dt, "ones"),
        (lay + "ln2", (n, d), dt, "ones"),
        (lay + "attn.wq", (n, d, hq), dt, d ** -0.5),
        (lay + "attn.wk", (n, d, hkv), dt, d ** -0.5),
        (lay + "attn.wv", (n, d, hkv), dt, d ** -0.5),
        (lay + "attn.wo", (n, hq, d), dt, hq ** -0.5),
        (lay + "moe.router", (n, d, e), rt, 0.02),
        (lay + "moe.w_gate", (n, e, d, f), dt, d ** -0.5),
        (lay + "moe.w_up", (n, e, d, f), dt, d ** -0.5),
        (lay + "moe.w_down", (n, e, f, d), dt, f ** -0.5),
    ]


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a run seeded ``seed``."""
    return (int(seed) * 1_000_003 + index) % 2**63


@torch.no_grad()
def draw(spec, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index``'s initial values, drawn in float32 on ``device`` from
    its own generator and rounded through the leaf's stored dtype: a
    float32 tensor."""
    _, shape, dtype, law = spec
    if law == "ones":
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, device=device).mul_(law)
    return x.to(dtype).float()


# --------------------------------------------------------------------------
# Matrix products: float32, or float8 for the control
# --------------------------------------------------------------------------


def _round(x, fmt):
    """``x`` rounded to the float8 format ``fmt`` under one scale for the
    tensor (its largest magnitude at the format's largest), and back."""
    amax = x.detach().abs().max()
    if amax == 0:
        return x
    scale = amax / FP8_MAX[fmt]
    return (x / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both inputs rounded to e4m3; the backward's products
    take the gradient rounded to e5m2 and the rounded inputs. ``b`` may
    have fewer leading dimensions than ``a`` (a weight)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, torch.float8_e4m3fn), _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return qg @ qb.transpose(-1, -2), gb


MATMUL = {"f32": torch.matmul, "fp8": _Fp8Matmul.apply}


# --------------------------------------------------------------------------
# Forward pass and loss
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotary embedding of ``x`` (B, H, S, D) at positions 0 … S-1, on
    interleaved pairs."""
    s, d = x.shape[-2], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float()
                            / d)
    ang = torch.arange(s, device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(p, i, h, cfg, mm):
    """Grouped-query attention of layer ``i`` over ``h`` (B, S, d)."""
    b, s, _ = h.shape
    hd, nq, nkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    pre = "moe_layers.attn."

    def heads(x, n):
        return x.view(b, s, n, hd).transpose(1, 2)

    q = rope(heads(mm(h, p[pre + "wq"][i]), nq), cfg["rope_theta"])
    k = rope(heads(mm(h, p[pre + "wk"][i]), nkv), cfg["rope_theta"])
    v = heads(mm(h, p[pre + "wv"][i]), nkv)
    k = k.repeat_interleave(nq // nkv, dim=1)
    v = v.repeat_interleave(nq // nkv, dim=1)
    scores = mm(q, k.transpose(-1, -2)) * hd ** -0.5
    qi = torch.arange(s, device=h.device)[:, None]
    ki = torch.arange(s, device=h.device)[None, :]
    keep = ki <= qi
    if cfg["sliding_window"] > 0:
        keep = keep & (qi - ki < cfg["sliding_window"])
    scores = scores.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(b, s, nq * hd), p[pre + "wo"][i])


def route(xt, router, cfg, mm):
    """The router's choice for the tokens ``xt`` (N, d): the top-k gates
    renormalised, the experts, and which assignments the capacity keeps
    (each ``(N, k)``)."""
    moe = cfg["moe"]
    k, e = moe["top_k"], moe["n_experts"]
    probs = torch.softmax(mm(xt, router), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    n = xt.shape[0]
    cap = int(max(k, moe["capacity_factor"] * n * k / e))
    onehot = F.one_hot(idx.reshape(-1), e)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return gates, idx, (pos < cap).view(n, k)


def experts(p, i, h, cfg, mm):
    """Layer ``i``'s mixture of experts over ``h`` (B, S, d), and the
    number of assignments dropped by the capacity."""
    b, s, d = h.shape
    xt = h.reshape(b * s, d)
    pre = "moe_layers.moe."
    gates, idx, keep = route(xt, p[pre + "router"][i], cfg, mm)
    out = torch.zeros_like(xt)
    k = idx.shape[1]
    tok = torch.arange(b * s, device=h.device)[:, None].expand(-1, k)
    for ex in range(cfg["moe"]["n_experts"]):
        sel = (idx == ex) & keep
        rows, g = tok[sel], gates[sel]
        x = xt[rows]
        y = mm(F.silu(mm(x, p[pre + "w_gate"][i, ex]))
               * mm(x, p[pre + "w_up"][i, ex]), p[pre + "w_down"][i, ex])
        out = out.index_add(0, rows, y * g[:, None])
    return out.view(b, s, d), (~keep).sum()


def loss(p, batch, cfg, mm=torch.matmul):
    """Mean cross-entropy of ``batch`` (``tokens``, ``labels``: (B, S)
    integers) under the parameters ``p`` (name → float32 leaf), and the
    assignments dropped in all layers."""
    eps = cfg["norm_eps"]
    x = p["embed"][batch["tokens"].long()]
    dropped = 0
    for i in range(cfg["n_layers"]):
        x = x + attention(p, i, rms_norm(x, p["moe_layers.ln1"][i], eps),
                          cfg, mm)
        y, drops = experts(p, i, rms_norm(x, p["moe_layers.ln2"][i], eps),
                           cfg, mm)
        x = x + y
        dropped = dropped + drops
    logits = mm(rms_norm(x, p["ln_f"], eps), p["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long()), dropped


# --------------------------------------------------------------------------
# Training steps
# --------------------------------------------------------------------------


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off while the reference runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of the 0-based ``step``: linear warm-up over
    ``warmup_steps``, then a cosine to ``min_lr_frac`` at
    ``total_steps``."""
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def _adamw(opt, x, g, m, v, lr, bc1, bc2, decay, dtype) -> None:
    """One AdamW update of ``x`` in place from its clipped gradient ``g``,
    stored back in ``dtype``."""
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    delta = (m / bc1) / ((v / bc2).sqrt() + opt["eps"])
    if decay:
        delta = delta + opt["weight_decay"] * x
    x.copy_((x - lr * delta).to(dtype).float())


def train(cfg: dict, seed: int, batches: list, device,
          mode: str = "f32") -> dict:
    """The configuration's training from the weights of ``seed`` over
    ``batches`` (one a step), in ``mode`` (``"f32"``, or ``"fp8"`` for the
    control). Returns ``loss`` (each step's), ``grad_norm`` (each leaf's
    gradient norm at the first step, before clipping), ``change_norm``
    (each leaf's ‖p − p0‖ after the last step) and ``dropped`` (each
    step's assignments past the capacity), as Python numbers."""
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
            grads = torch.autograd.grad(value, list(p.values()))
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
                grads = list(grads)
                for j, (name, _, dtype, _) in enumerate(specs):
                    x, g = p[name], grads[j]
                    grads[j] = None
                    decay = x.dim() >= 2
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
