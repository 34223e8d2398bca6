"""Public wrapper for attention: the kernel on a CUDA tensor, the chunked
plain version on the CPU (the port of the JAX package's
``kernels/flash_attention/ops.py``, whose "TPU backend" test becomes the
tensor's device)."""

from __future__ import annotations

from .flash_attention import flash_attention
from .ref import attention_chunked_ref, attention_ref


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, use_kernel: bool | None = None):
    """Dispatch attention to the CUDA kernel or the chunked torch version.

    ``use_kernel=None`` picks the kernel for a CUDA tensor and the chunked
    version for a CPU one. On a CUDA tensor the kernel builds and launches
    or raises; it never falls back quietly. ``use_kernel=False`` runs the
    chunked version on any device (the plain model on the card).
    """
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    sk = k.shape[2]
    chunk = 512 if sk % 512 == 0 else sk
    return attention_chunked_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk=chunk)


__all__ = ["attention", "attention_chunked_ref", "attention_ref",
           "flash_attention"]
