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
(docs/port.md §hybrid). f32 (the tests' exact path) and bf16 at D 32 run
a simple kernel (scalar FMAs or WMMA fragments).

``block_q`` and ``block_k`` are the reference's API and validation only:
the CUDA tiles are the kernel's own, and the output does not depend on
them. On a CPU tensor :func:`flash_attention` runs
:func:`flash_attention_plain`; on a CUDA tensor it launches the kernel or
raises. The kernel has no backward: on a CUDA input that requires grad
(grad mode on) the call raises rather than return an output that drops
the gradient; ``ops.attention`` wraps it in ``FlashAttentionFn`` there
(docs/port.md §train).
"""

from __future__ import annotations

import torch

from .ref import attention_chunked_ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: Head dims the CUDA file instantiates, and the dtypes it takes.
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
                    block_k: int = DEFAULT_BLOCK_K):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    The output has ``q``'s dtype and is laid out ``(B, Sq, Hq, D)`` in
    memory (a transposed view), so merging its heads is free.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"S ({sq},{sk}) must tile by ({block_q},{block_k})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_k=block_k)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention launches a kernel with no backward, and an "
            "input requires grad: call ops.attention, which runs it inside "
            "FlashAttentionFn, or run under torch.no_grad()")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    from repro_torch.kernels.build import (
        FlashStrides,
        check,
        load_flash_library,
    )

    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    st = FlashStrides()
    for i, x in enumerate((q, k, v, out)):
        for j, s in enumerate(_strides(x)):
            st.s[3 * i + j] = s
    lib = load_flash_library()
    check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, hq, hkv, sq, sk, d, st, float(scale),
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
