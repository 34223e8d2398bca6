"""Hand-written Hopper flash attention (``csrc/flash_attention.cu``).

Replaces the JAX package's ``kernels/flash_attention/flash_attention.py:
flash_attention`` (with ``_kernel``): blocked online-softmax attention with
the causal diagonal anchored at the end of the KV, a sliding window, GQA
and wholly masked key tiles skipped, the running max, denominator and
accumulator in f32 (docs/port.md §lm).

Bound on the card: operations. At the Qwen3-8B prefill launch (bf16, B 4,
Hq 32, Hkv 8, S 2048, D 128, causal) the two products are 137.5 GFLOP
against 168 MB that q, k, v and o move once, about 820 flops per byte,
above the card's bf16 ridge of ~295. bf16 at D 64, 112 and 128 therefore
runs a warp-specialised kernel: TMA loads into a two-stage K/V ring,
``wgmma`` for both products, the softmax and the accumulator in
registers. D 112 (Zamba2's shared attention) is held at D 128's layout in
shared memory, its 16 extra columns zero-filled by TMA and never stored
(docs/port.md §hybrid). Multi-head latent attention (Kimi K2) runs the
same kernels at D 192 for q and k and D 128 for v and the output
(docs/port.md §mla). f32 (the tests' exact path) and bf16 at D 32 run a
simple kernel (scalar FMAs or WMMA fragments).

``block_q`` and ``block_k`` are the reference's API and validation only:
the CUDA tiles are the kernel's own, and the output does not depend on
them. On a CPU tensor :func:`flash_attention` runs
:func:`flash_attention_plain`; on a CUDA tensor it launches the kernel or
raises. :func:`flash_attention` itself records no gradient: on a CUDA
input that requires grad (grad mode on) the call raises rather than
return an output that drops the gradient; ``ops.attention`` wraps it in
``FlashAttentionFn`` there (docs/port.md §train). On the Hopper path the
forward can also write what the backward needs (``for_backward``: each
row's log-sum-exp and the output in f32), and :func:`flash_attention_bwd`
is that path's backward, a kernel of its own (three launches: D =
rowsum(dO o O), then dK and dV a key tile a block summed over the query
heads of the group, then dQ a query tile a block), with
:func:`flash_attention_bwd_plain` its plain version.
"""

from __future__ import annotations

from collections import Counter

import torch

from .ref import _mask, _repeat_kv, attention_chunked_ref, attention_lse_ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: Head dims the CUDA file instantiates where v has k's, and the dtypes it
#: takes.
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (D of q and k, D of v) of the Hopper kernels (bf16), the backward's
#: too: the models' heads, and multi-head latent attention's 192 / 128.
HOPPER_DIMS = ((64, 64), (112, 112), (128, 128), (192, 128))
#: Rows of the backward's tiles; its log-sum-exp and D rows are padded to
#: a multiple of it.
BWD_TILE = 64


def takes_hopper_path(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the forward on ``q`` and ``v`` runs the Hopper kernel (the C
    entry's rule: bf16 at a pair of :data:`HOPPER_DIMS` on the card), and
    so whether its backward is :func:`flash_attention_bwd`."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and (q.shape[-1], v.shape[-1]) in HOPPER_DIMS)


def _check_shapes(q, k, v) -> None:
    """q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv): v may be
    narrower or wider than k in its last dim alone."""
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"need q (B, Hq, Sq, D), k (B, Hkv, Sk, D) and v "
                         f"(B, Hkv, Sk, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} must be a multiple of "
                         f"Hkv={k.shape[1]}")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None,
                          block_k: int = DEFAULT_BLOCK_K):
    """The kernel's plain version: online softmax over ``block_k`` key
    chunks (``attention_chunked_ref``)."""
    return attention_chunked_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk=min(block_k, k.shape[2]))


def _strides(x: torch.Tensor) -> list[int]:
    """The (batch, head, seq) strides of ``x`` in elements. A dim of size
    1 is never stepped along, so it gets the contiguous stride, whatever
    torch keeps there."""
    _, h, s, d = x.shape
    dense = (h * s * d, s * d, d)
    return [x.stride(i) if x.shape[i] > 1 else dense[i] for i in range(3)]


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it in place, else a
    contiguous copy.

    The kernel reads q, k and v through TMA descriptors over (D, S, H, B),
    which need a 16-byte-aligned base, unit stride along D and the other
    strides multiples of 16 bytes. The transposed views of the model's
    head split meet that rule and are read in place.
    """
    vec = 16 // x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in _strides(x))):
        return x
    return x.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    for_backward: bool = False):
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv) -> (B,
    Hq, Sq, Dv). On the card Dv is D but at (192, 128) (:data:`HOPPER_DIMS`).

    The output has ``q``'s dtype and is laid out ``(B, Sq, Hq, Dv)`` in
    memory (a transposed view), so merging its heads is free. With
    ``for_backward`` it returns ``(out, lse, out_f32)``: each row's f32
    log-sum-exp of the masked scaled logits, ``(B, Hq, Sq)`` (a view of
    rows padded to :data:`BWD_TILE`), and the output before its rounding
    to ``q``'s dtype, f32 and contiguous, what :func:`flash_attention_bwd`
    takes; on a CUDA tensor only the Hopper kernel writes them. Every
    launch counts in ``flash_attention.launches`` and, by (D, Dv), in
    ``flash_attention.launches_at``.
    """
    _check_shapes(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"S ({sq},{sk}) must tile by ({block_q},{block_k})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        if for_backward:
            # the plain version computes in f32 and rounds at the end
            out = flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window,
                                        scale=scale, block_k=block_k)
            return out.to(q.dtype), attention_lse_ref(
                q, k, causal=causal, window=window, scale=scale), out
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_k=block_k)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention launches a kernel with no backward, and an "
            "input requires grad: call ops.attention, which runs it inside "
            "FlashAttentionFn, or run under torch.no_grad()")
    hopper = takes_hopper_path(q, v)
    if not hopper and (d_v != d or d not in HEAD_DIMS):
        raise ValueError(f"head dims (D, Dv)=({d}, {d_v}) are not the "
                         f"kernel's: D of {HEAD_DIMS} with Dv = D, or bf16 "
                         f"at {HOPPER_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if for_backward and not hopper:
        raise ValueError("the log-sum-exp and the f32 output are written by "
                         f"the Hopper kernel alone (bf16 at (D, Dv) of "
                         f"{HOPPER_DIMS}), not for {q.dtype} at D {d}")
    from repro_torch.kernels.build import (
        FlashStrides,
        check,
        load_flash_library,
    )

    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((b, sq, hq, d_v), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    st = FlashStrides()
    for i, x in enumerate((q, k, v, out)):
        for j, s in enumerate(_strides(x)):
            st.s[3 * i + j] = s
    lse = out32 = None
    if for_backward:
        lse = torch.empty((b, hq, _round_up(sq, BWD_TILE)),
                          dtype=torch.float32, device=q.device)[..., :sq]
        out32 = torch.empty((b, hq, sq, d_v), dtype=torch.float32,
                            device=q.device)
    lib = load_flash_library()
    check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, hq, hkv, sq, sk, d, d_v, st, float(scale),
        int(causal), int(window),
        None if lse is None else lse.data_ptr(),
        0 if lse is None else lse.stride(0),
        0 if lse is None else lse.stride(1),
        None if out32 is None else out32.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_at[d, d_v] += 1
    return (out, lse, out32) if for_backward else out


flash_attention.launches = 0
flash_attention.launches_at = Counter()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None):
    """The backward's plain version: ``(dq, dk, dv)`` of attention at the
    forward's output ``o`` and log-sum-exp ``lse`` for the output's
    gradient ``do``. In f32: S = scale Q K^T under the forward's mask, P =
    exp(S - LSE) (0 where masked), D = rowsum(dO o O), dP = dO V^T, dS =
    P (dP - D); then dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K with
    P and dS rounded to ``q``'s dtype as the kernel rounds its MMA
    operands, dK and dV summed over each KV head's group of query heads.
    The gradients take the inputs' dtypes; v may be narrower than k
    (multi-head latent attention)."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kf = _repeat_kv(k, hq // hkv).float()
    vf = _repeat_kv(v, hq // hkv).float()
    qf, of, dof = q.float(), o.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _mask(sq, sk, sk - sq, 0, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale

    def per_kv_head(x):
        b = x.shape[0]
        return x.view(b, hkv, hq // hkv, sk, x.shape[3]).sum(2)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


def _lse_operand(lse: torch.Tensor, sq: int) -> torch.Tensor:
    """``lse`` itself when the backward can read its rows whole, else a
    copy into rows padded to :data:`BWD_TILE`.

    The kernel reads a 64-row tile's log-sum-exps with one 16-byte-aligned
    bulk copy, past Sq in the last tile: it needs unit stride along Sq, a
    row stride that is a multiple of 4 floats and holds the padded rows,
    the batch stride of whole rows, and storage under every padded row.
    :func:`flash_attention` returns such a view.
    """
    b, h, _ = lse.shape
    vs, rows = lse.stride(1), _round_up(sq, BWD_TILE)
    if (lse.stride(2) == 1 and vs % 4 == 0 and vs >= rows
            and lse.stride(0) == h * vs and lse.data_ptr() % 16 == 0
            and lse.untyped_storage().nbytes() // 4
            >= lse.storage_offset() + (b * h - 1) * vs + rows):
        return lse
    out = lse.new_empty((b, h, rows))[..., :sq]
    out.copy_(lse)
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The Hopper path's backward: ``(dq, dk, dv)`` from q ``(B, Hq, Sq,
    D)``, k ``(B, Hkv, Sk, D)`` and v ``(B, Hkv, Sk, Dv)``, the forward's
    f32 output ``o`` and log-sum-exp ``lse`` ``(B, Hq, Sq)``
    (``flash_attention(..., for_backward=True)``), and the output's
    gradient ``do`` (o's shape); q, k, v and ``do`` bf16 at a pair of
    :data:`HOPPER_DIMS`; the forward's ``causal``, ``window`` and
    ``scale``. ``o`` in f32 makes D = rowsum(dO o O) exact: from the
    bf16 output, D's error breaks sum_k dS = 0, which dQ and the keys'
    summed dK lean on where the keys share a large mean (whisper's
    cross-attention: dQ off by ~10%). Each gradient is laid out ``(B, S,
    H, D)`` in memory, as the forward's output is. On a CPU tensor it runs
    :func:`flash_attention_bwd_plain`; on a CUDA tensor it launches the
    kernels or raises. A launch is deterministic: each gradient element is
    summed by one block in a fixed order."""
    _check_shapes(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, d_v = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (b, hq, sq, d_v) or do.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be {(b, hq, sq, d_v)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(b, hq, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, do)):
        raise TypeError("the backward kernel takes bf16 q, k, v and do, got "
                        f"{[str(x.dtype) for x in (q, k, v, do)]}")
    if o.dtype != torch.float32:
        raise TypeError(f"o must be the forward's f32 output, got {o.dtype}")
    if (d, d_v) not in HOPPER_DIMS:
        raise ValueError(f"head dims (D, Dv)=({d}, {d_v}) are not one of the "
                         f"backward kernel's {HOPPER_DIMS}")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale)
    if any(x.device != q.device for x in (k, v, o, lse, do)):
        raise ValueError("every operand must be on one device")
    from repro_torch.kernels.build import (
        FlashStrides,
        check,
        load_flash_library,
    )

    q, k, v, o, do = (_kernel_operand(x) for x in (q, k, v, o, do))
    lse = _lse_operand(lse, sq)
    vs = lse.stride(1)
    dvec = torch.empty((b, hq, vs), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((b, sk, hkv, n), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for n in (d, d_v))
    st_in, st_grad = FlashStrides(), FlashStrides()
    for st, xs in ((st_in, (q, k, v, o)), (st_grad, (dq, dk, dv, do))):
        for i, x in enumerate(xs):
            for j, s in enumerate(_strides(x)):
                st.s[3 * i + j] = s
    lib = load_flash_library()
    check(lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, d, d_v, vs, st_in,
        st_grad, float(scale), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_at[d, d_v] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_at = Counter()
