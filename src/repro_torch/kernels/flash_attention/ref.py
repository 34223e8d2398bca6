"""Plain torch versions of blocked attention (the port of the JAX
package's ``kernels/flash_attention/ref.py``).

``attention_ref``          — direct softmax attention (small shapes).
``attention_chunked_ref``  — online softmax over key chunks, O(S) memory;
                             the attention the models run on the CPU, and
                             the kernel's plain version on the card.
``attention_lse_ref``      — each row's log-sum-exp of the masked scaled
                             logits, what the forward saves for the
                             backward.

Both take q ``(B, Hq, Sq, D)``, k ``(B, Hkv, Sk, D)`` and v ``(B, Hkv,
Sk, Dv)`` (``Dv`` may differ from ``D``: multi-head latent attention's
192 / 128), support GQA (kv head = h // (Hq / Hkv),
``repeat_interleave``), causal masking with the diagonal anchored at the
end of the KV (``sk - sq``), and sliding windows. Logits and softmax run
in f32; masked logits are the finite ``-1e30``; the output is in
``q.dtype``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, q0: int, k0: int, causal: bool, window: int,
          device) -> torch.Tensor:
    q_idx = q0 + torch.arange(sq, device=device)[:, None]
    k_idx = k0 + torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= q_idx >= k_idx
    if window > 0:
        m &= q_idx - k_idx < window
    return m


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=1)


def attention_ref(q, k, v, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """Direct attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D)."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _mask(sq, sk, sk - sq, 0, causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_chunked_ref(q, k, v, causal: bool = True, window: int = 0,
                          scale: float | None = None, chunk: int = 512):
    """Online-softmax attention over key chunks (flash semantics)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    if sk % chunk:
        chunk = sk  # degenerate: single chunk
    acc = torch.zeros((b, hq, sq, v.shape[3]), dtype=torch.float32,
                      device=q.device)
    m_i = torch.full((b, hq, sq), float("-inf"), device=q.device)
    l_i = torch.zeros((b, hq, sq), device=q.device)
    for i in range(sk // chunk):
        kb = k[:, :, i * chunk:(i + 1) * chunk].float()
        vb = v[:, :, i * chunk:(i + 1) * chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        msk = _mask(sq, chunk, sk - sq, i * chunk, causal, window, q.device)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m_i, s.amax(-1))
        alpha = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        l_i = l_i * alpha + p.sum(-1)
        m_i = m_new
    return (acc / torch.clamp(l_i, min=1e-30)[..., None]).to(q.dtype)


def attention_lse_ref(q, k, causal: bool = True, window: int = 0,
                      scale: float | None = None):
    """``logsumexp`` over the keys of the scaled logits, masked at
    ``-1e30``: f32 ``(B, Hq, Sq)``."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _mask(sq, sk, sk - sq, 0, causal, window, q.device)
    return torch.logsumexp(torch.where(mask, logits, NEG_INF), dim=-1)
