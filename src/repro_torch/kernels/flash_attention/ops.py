"""Public wrapper for attention: the kernel on a CUDA tensor, the chunked
plain version on the CPU (the port of the JAX package's
``kernels/flash_attention/ops.py``, whose "TPU backend" test becomes the
tensor's device), and the kernel with a gradient
(:class:`FlashAttentionFn`) where one is asked for."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .flash_attention import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    flash_attention,
    flash_attention_bwd,
    takes_hopper_path,
)
from .ref import attention_chunked_ref, attention_ref


def _chunk(sk: int) -> int:
    """The chunk of the reference's model path: 512 where it divides the
    keys, else all of them."""
    return 512 if sk % 512 == 0 else sk


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient. The forward is
    :func:`flash_attention` (the hand-written kernel on a CUDA tensor).
    Where it runs the Hopper kernel (:func:`takes_hopper_path`: bf16 at D
    64, 112 or 128, or at 192 with v at 128, on the card) it also saves
    each row's log-sum-exp and the output in f32, and the backward is the
    hand-written :func:`flash_attention_bwd`. Elsewhere (f32, the tests'
    exact path; D 32; the CPU) the backward recomputes attention from the
    saved q, k and v through :func:`attention_chunked_ref` at the model
    path's chunk and differentiates that, the function the reference's
    model path differentiates (docs/port.md §train)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k):
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        blocks = dict(block_q=block_q, block_k=block_k)
        if takes_hopper_path(q, v):
            out, lse, out32 = flash_attention(q, k, v, **ctx.kw, **blocks,
                                              for_backward=True)
            ctx.save_for_backward(q, k, v, out32, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **ctx.kw, **blocks)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if len(saved) == 5:
            gs = flash_attention_bwd(*saved, grad_out, **ctx.kw)
        else:
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(n)
                      for x, n in zip(saved, need)]
                o = attention_chunked_ref(*xs, **ctx.kw,
                                          chunk=_chunk(xs[1].shape[2]))
                it = iter(torch.autograd.grad(
                    o, [x for x in xs if x.requires_grad], grad_out))
                gs = [next(it) if n else None for n in need]
        return (*(g if n else None for g, n in zip(gs, need)),
                None, None, None, None, None)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, use_kernel: bool | None = None):
    """Dispatch attention to the CUDA kernel or the chunked torch version.

    ``use_kernel=None`` picks the kernel for a CUDA tensor and the chunked
    version for a CPU one. On a CUDA tensor the kernel builds and launches
    or raises; it never falls back quietly. ``use_kernel=False`` runs the
    chunked version on any device (the plain model on the card). Any
    length is taken: the reference's model path never tiles. With grad
    mode on and an input that requires grad, the kernel runs inside
    :class:`FlashAttentionFn`, whose backward is the backward kernel on
    the Hopper path and the chunked version's elsewhere.
    """
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    sk = k.shape[2]
    if use_kernel:
        # Blocks that tile any length, as the chunk rule below does: the
        # kernel's own tiles take ragged ends (docs/port.md §encdec).
        sq = q.shape[2]
        blocks = (DEFAULT_BLOCK_Q if sq % DEFAULT_BLOCK_Q == 0 else sq,
                  DEFAULT_BLOCK_K if sk % DEFAULT_BLOCK_K == 0 else sk)
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                          *blocks)
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, block_q=blocks[0],
                               block_k=blocks[1])
    return attention_chunked_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk=_chunk(sk))


__all__ = ["FlashAttentionFn", "attention", "attention_chunked_ref",
           "attention_ref", "flash_attention"]
