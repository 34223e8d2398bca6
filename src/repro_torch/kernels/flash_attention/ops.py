"""Public wrapper for attention: the kernel on a CUDA tensor, the chunked
plain version on the CPU (the port of the JAX package's
``kernels/flash_attention/ops.py``, whose "TPU backend" test becomes the
tensor's device)."""

from __future__ import annotations

from .flash_attention import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    flash_attention,
)
from .ref import attention_chunked_ref, attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, use_kernel: bool | None = None):
    """Dispatch attention to the CUDA kernel or the chunked torch version.

    ``use_kernel=None`` picks the kernel for a CUDA tensor and the chunked
    version for a CPU one. On a CUDA tensor the kernel builds and launches
    or raises; it never falls back quietly. ``use_kernel=False`` runs the
    chunked version on any device (the plain model on the card). Any
    length is taken: the reference's model path never tiles.
    """
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        # Blocks that tile any length, as the chunk rule below does: the
        # kernel's own tiles take ragged ends (docs/port.md §encdec).
        sq, sk = q.shape[2], k.shape[2]
        return flash_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            block_q=DEFAULT_BLOCK_Q if sq % DEFAULT_BLOCK_Q == 0 else sq,
            block_k=DEFAULT_BLOCK_K if sk % DEFAULT_BLOCK_K == 0 else sk)
    sk = k.shape[2]
    chunk = 512 if sk % 512 == 0 else sk
    return attention_chunked_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk=chunk)


__all__ = ["attention", "attention_chunked_ref", "attention_ref",
           "flash_attention"]
