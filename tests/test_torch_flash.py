"""The port's attention (``repro_torch.kernels.flash_attention``) against
the JAX package's on the same numpy inputs, on the CPU.

The JAX Pallas kernel runs in interpret mode (its default). The port's
wrapper takes its plain version for a CPU tensor, so these tests hold the
plain versions and the dispatcher to the reference; the CUDA kernel is
held to the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jax_flash,
)
from repro.kernels.flash_attention.ref import (
    attention_chunked_ref as jax_chunked,
    attention_ref as jax_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked_ref,
    attention_ref,
)

#: f32 plain versions against the JAX ones: the same f32 operations,
#: summed in another order by torch and XLA.
REF_TOL = dict(rtol=1e-5, atol=1e-5)
#: Against the JAX kernel, as tests/test_kernels.py holds it to its ref.
KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)
#: bf16 inputs and outputs (tests/test_kernels.py::test_flash_dtypes).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

CASES = {
    "mha": (1, 2, 2, 128, 128, True, 0),
    "mqa": (2, 4, 1, 128, 128, True, 0),
    "gqa_prefix": (1, 4, 2, 64, 256, True, 0),
    "bidirectional": (1, 2, 2, 128, 128, False, 0),
    "window": (1, 2, 2, 256, 256, True, 64),
}


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_and_dispatcher_match_jax(case):
    b, hq, hkv, sq, sk, causal, window = CASES[case]
    q, k, v = _qkv(42, b, hq, hkv, sq, sk, 64)
    kw = dict(causal=causal, window=window)
    want = np.asarray(jax_ref(*_j(q, k, v), **kw))
    np.testing.assert_allclose(attention_ref(*_t(q, k, v), **kw).numpy(),
                               want, **REF_TOL)
    np.testing.assert_allclose(
        attention_chunked_ref(*_t(q, k, v), chunk=64, **kw).numpy(),
        np.asarray(jax_chunked(*_j(q, k, v), chunk=64, **kw)), **REF_TOL)
    kern = np.asarray(jax_flash(*_j(q, k, v), block_q=64, block_k=64, **kw))
    got = attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), kern, **KERNEL_TOL)
    np.testing.assert_allclose(
        flash_attention(*_t(q, k, v), block_q=64, block_k=64, **kw).numpy(),
        kern, **KERNEL_TOL)


@pytest.mark.parametrize("blocks", [(32, 32), (64, 128)])
def test_block_shapes_match_jax_kernel(blocks):
    bq, bk = blocks
    q, k, v = _qkv(3, 1, 2, 2, 128, 256, 64)
    want = np.asarray(jax_flash(*_j(q, k, v), block_q=bq, block_k=bk))
    got = flash_attention(*_t(q, k, v), block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_bf16_matches_jax_kernel():
    q, k, v = _qkv(7, 1, 2, 2, 128, 128, 64)
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in _j(q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64),
                      np.float32)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = flash_attention(tq, tk, tv, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mha", "gqa_prefix", "window"])
def test_head_dim_112_matches_jax_kernel(case, dtype):
    """D 112, Zamba2's shared attention (3584 / 32): the JAX kernel takes
    any D whole; the port's kernel pads it to 128 in shared memory, and
    its plain version (the CPU path) is held to the JAX kernel here."""
    b, hq, hkv, sq, sk, causal, window = CASES[case]
    q, k, v = _qkv(11, b, hq, hkv, sq, sk, 112)
    jq, jk, jv = (x.astype(dtype) for x in _j(q, k, v))
    tq, tk, tv = (x.to(getattr(torch, dtype)) for x in _t(q, k, v))
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    want = np.asarray(jax_flash(jq, jk, jv, **kw), np.float32)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.shape == (b, hq, sq, 112) and got.dtype == tq.dtype
    tol = KERNEL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_dispatcher_cpu_path_equals_jax_dispatcher():
    """``use_kernel=None`` on the CPU is the chunked version with the
    reference's chunk rule (512 when it divides Sk)."""
    q, k, v = _qkv(9, 1, 2, 2, 128, 1024, 32)
    want = np.asarray(jax_attention(*_j(q, k, v)))
    got = attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    assert torch.equal(got, attention_chunked_ref(*_t(q, k, v), chunk=512))


@pytest.mark.parametrize("shape", [(1500, 1500, False), (375, 1500, False),
                                   (1000, 1000, True)])
def test_dispatcher_kernel_path_takes_any_length(shape):
    """``use_kernel=True`` takes every length the reference's model path
    takes (whisper's 1500 frames, its 375 x 1500 cross-attention, a
    1000-token prompt), though none tiles by the default blocks: on a CPU
    tensor it equals the chunked path bitwise, and the JAX dispatcher's
    reference path within f32 rounding."""
    sq, sk, causal = shape
    q, k, v = _qkv(13, 1, 2, 2, sq, sk, 64)
    got = attention(*_t(q, k, v), causal=causal, use_kernel=True)
    assert torch.equal(got, attention(*_t(q, k, v), causal=causal,
                                      use_kernel=False))
    want = np.asarray(jax_attention(*_j(q, k, v), causal=causal,
                                    use_pallas=False))
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)


def test_rejections_match_the_reference():
    q, k, v = _t(*_qkv(0, 1, 3, 2, 64, 64, 32))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, v)
    q, k, v = _t(*_qkv(0, 1, 2, 2, 96, 96, 32))
    with pytest.raises(ValueError, match="must tile"):
        flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.double(), k.double(), v.double())


def test_kernel_operand_reads_head_split_views_in_place():
    """The host side of the kernel's TMA rule: the model's head-split view
    (bf16, D 128) is taken in place with its own strides; a view whose
    row stride is not a multiple of 16 bytes, or whose last stride is not
    1, is copied contiguous; a dim of size 1 reports the contiguous
    stride."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _kernel_operand,
        _strides,
    )
    from repro_torch.models.layers import _split_heads

    x = torch.randn((2, 64, 4 * 128)).to(torch.bfloat16)
    q = _split_heads(x, 4)
    assert _kernel_operand(q) is q
    assert _strides(q) == [64 * 4 * 128, 128, 4 * 128]

    padded = torch.randn((2, 4, 64, 129)).to(torch.bfloat16)[..., :128]
    assert padded.stride(2) * 2 % 16 != 0
    got = _kernel_operand(padded)
    assert got is not padded and got.is_contiguous()
    assert torch.equal(got, padded)

    col = torch.randn((2, 4, 128, 64)).to(torch.bfloat16).transpose(2, 3)
    assert _kernel_operand(col).is_contiguous()

    one = torch.randn((1, 64, 4 * 128)).to(torch.bfloat16)
    assert _strides(_split_heads(one, 4)) == [4 * 64 * 128, 128, 4 * 128]


def test_kernel_operand_reads_zamba2_head_split_views_in_place():
    """Zamba2's shared block at D 112 (32 heads of 3584): the head-split
    view's strides are 224 B (head) and 7,168 B (sequence), multiples of
    16 bytes, so TMA reads q, k and v in place."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _kernel_operand,
        _strides,
    )
    from repro_torch.models.layers import _split_heads

    x = torch.zeros((2, 16, 32 * 112), dtype=torch.bfloat16)
    q = _split_heads(x, 32)
    assert q.shape == (2, 32, 16, 112)
    assert [2 * s for s in _strides(q)] == [2 * 16 * 3584, 224, 7168]
    assert _kernel_operand(q) is q
