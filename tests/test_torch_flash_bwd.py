"""Flash attention's backward (``flash_attention_bwd`` and its plain
version) on the CPU.

The CUDA kernel runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 11b). Here the plain version, which computes the
kernel's formulas with its roundings, is held to autograd through
``attention_chunked_ref`` at the card tests' shapes, the forward's
log-sum-exp to the softmax it normalises, and the wrapper to what the
kernel takes.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_TILE,
    _lse_operand,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    takes_hopper_path,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (
    _mask,
    _repeat_kv,
    attention_chunked_ref,
    attention_lse_ref,
    attention_ref,
)

#: f32: the same function as autograd's, with P = exp(S - LSE) in place of
#: the online softmax's normalisation, summed in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: bf16 operands, P and dS rounded to bf16 as MMA operands: the card
#: tests' bf16 gradient tolerance.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

#: (B, Hq, Hkv, Sq, Sk, D, causal, window): the card tests' shapes.
SHAPES = {
    "mha": (1, 4, 4, 256, 256, 64, True, 0),
    "gqa_window": (2, 8, 2, 384, 384, 64, True, 128),
    "zamba2_d112": (2, 4, 4, 256, 256, 112, True, 0),
    "encoder_ragged": (2, 4, 4, 300, 300, 64, False, 0),
    "cross_sq_lt_sk": (2, 4, 4, 75, 300, 64, False, 0),
    "gqa7": (1, 14, 2, 256, 256, 128, True, 0),
    "causal_prefix": (1, 4, 2, 64, 256, 128, True, 0),
    "ragged_window_mqa": (1, 4, 1, 100, 100, 64, True, 32),
    "bidirectional_window": (1, 2, 2, 130, 130, 128, False, 48),
}


def _inputs(shape, dtype=torch.float32, seed=0):
    b, hq, hkv, sq, sk, d, _, _ = shape
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    return (mk(b, hq, sq, d), mk(b, hkv, sk, d), mk(b, hkv, sk, d),
            mk(b, hq, sq, d))


def _autograd(q, k, v, do, causal, window):
    """dq, dk, dv of autograd through the chunked plain version, and its
    output."""
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = attention_chunked_ref(*xs, causal=causal, window=window,
                              chunk=k.shape[2])
    return o.detach(), torch.autograd.grad(o, xs, do)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_backward_equals_autograd_in_f32(name):
    """In f32 the plain backward (P from the saved log-sum-exp, D =
    rowsum(dO o O), dS = P (dP - D)) is autograd through the chunked
    plain version, masks, GQA groups, Sq != Sk and ragged lengths
    included."""
    *_, causal, window = SHAPES[name]
    q, k, v, do = _inputs(SHAPES[name])
    o, want = _autograd(q, k, v, do, causal, window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g, w, **F32_TOL)


@pytest.mark.parametrize("name", ["gqa_window", "zamba2_d112",
                                  "cross_sq_lt_sk", "gqa7"])
def test_plain_backward_in_bf16_within_the_card_tolerance(name):
    """With bf16 operands, P and dS rounded to bf16 as the kernel rounds
    them, the gradients stay within the card tests' bf16 tolerance of
    autograd in f32 on the same (bf16-valued) inputs."""
    *_, causal, window = SHAPES[name]
    q, k, v, do = _inputs(SHAPES[name], torch.bfloat16, seed=1)
    o32, want = _autograd(*(x.float() for x in (q, k, v, do)), causal,
                          window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    got = flash_attention_bwd_plain(q, k, v, o32, lse, do, causal=causal,
                                    window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, **BF16_TOL)


@pytest.mark.parametrize("name", ["mha", "gqa_window", "causal_prefix",
                                  "bidirectional_window"])
def test_lse_normalises_the_forwards_softmax(name):
    """exp(S - LSE) over the kept keys is the forward's softmax: its rows
    sum to 1, and P V is the direct attention's output."""
    *_, causal, window = SHAPES[name]
    q, k, v, _ = _inputs(SHAPES[name])
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q, _repeat_kv(k, hq // hkv)) * (
        d ** -0.5)
    mask = _mask(sq, sk, sk - sq, 0, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(b, hq, sq), **F32_TOL)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _repeat_kv(v, hq // hkv))
    torch.testing.assert_close(o, attention_ref(q, k, v, causal=causal,
                                                window=window), **F32_TOL)
    kw = dict(causal=causal, window=window, block_q=sq, block_k=sk)
    out, lse2, out32 = flash_attention(q, k, v, **kw, for_backward=True)
    assert torch.equal(lse2, lse) and out32.dtype == torch.float32
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    assert torch.equal(out32, out)  # f32 inputs: no rounding


def test_backward_wrapper_on_the_cpu_runs_the_plain_version():
    """On a CPU tensor the wrapper is the plain version, bitwise, laid out
    as the inputs are, and counts no launch."""
    shape = SHAPES["gqa_window"]
    *_, causal, window = shape
    q, k, v, do = _inputs(shape, torch.bfloat16, seed=2)
    _, lse, o = flash_attention(q, k, v, causal=causal, window=window,
                                for_backward=True)
    n = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    assert flash_attention_bwd.launches == n
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bad(case):
    q, k, v, do = _inputs(SHAPES["gqa_window"], torch.bfloat16)
    lse = attention_lse_ref(q, k, window=128)
    o = do.float()
    args = dict(q=q, k=k, v=v, o=o, lse=lse, do=do)
    if case == "f32":
        args = {n: x.float() for n, x in args.items()}
    elif case == "d32":
        q, k, v, do = _inputs((1, 2, 2, 64, 64, 32, True, 0), torch.bfloat16)
        args = dict(q=q, k=k, v=v, o=do.float(), do=do,
                    lse=attention_lse_ref(q, k))
    elif case == "lse_shape":
        args["lse"] = lse[:, :, :-1]
    elif case == "lse_dtype":
        args["lse"] = lse.bfloat16()
    elif case == "o_shape":
        args["o"] = o[:, :, :-1]
    elif case == "o_dtype":
        args["o"] = do
    elif case == "group":
        args["k"], args["v"] = k[:, :1].expand(-1, 3, -1, -1), v[:, :1].expand(
            -1, 3, -1, -1)
    elif case == "kv_shape":
        args["v"] = v[:, :, :-1]
    return args


@pytest.mark.parametrize("case,err", [
    ("f32", TypeError), ("d32", ValueError), ("lse_shape", ValueError),
    ("lse_dtype", ValueError), ("o_shape", ValueError), ("o_dtype", TypeError),
    ("group", ValueError), ("kv_shape", ValueError)])
def test_backward_wrapper_raises_on_what_the_kernel_does_not_take(case, err):
    """The wrapper takes what the kernel takes, on any device: bf16 q, k,
    v and do at D 64, 112 or 128, the f32 output o and (B, Hq, Sq)
    log-sum-exp, o and do of q's shape, k and v of one shape, Hq a
    multiple of Hkv."""
    with pytest.raises(err):
        flash_attention_bwd(**_bad(case))


def test_lse_operand_reads_padded_rows_in_place_and_pads_others():
    """The forward's log-sum-exp (rows padded to the backward's tile) is
    read in place; a dense (B, Hq, Sq) one is copied into padded rows,
    values unchanged."""
    b, h, sq = 2, 3, 100
    rows = -(-sq // BWD_TILE) * BWD_TILE
    padded = torch.randn(b, h, rows)[..., :sq]
    assert _lse_operand(padded, sq) is padded
    dense = torch.randn(b, h, sq)
    got = _lse_operand(dense, sq)
    assert got.stride() == (h * rows, rows, 1) and torch.equal(got, dense)
    # a view whose last padded row lies past the storage
    tail = torch.randn((b * h - 1) * rows + sq).as_strided(
        (b, h, sq), (h * rows, rows, 1))
    assert _lse_operand(tail, sq) is not tail


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_off_the_hopper_path_keeps_the_recompute(dtype):
    """Off the Hopper path (here: the CPU) ``FlashAttentionFn`` saves q, k
    and v alone and its backward is autograd through the chunked plain
    version; no backward kernel launches."""
    shape = SHAPES["gqa_window"]
    *_, causal, window = shape
    q, k, v, do = _inputs(shape, dtype, seed=3)
    assert not takes_hopper_path(q, v)
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    n = flash_attention_bwd.launches
    out = attention(*xs, causal=causal, window=window, use_kernel=True)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, xs, do)
    assert flash_attention_bwd.launches == n
    ref = attention_chunked_ref(*xs, causal=causal, window=window,
                                chunk=k.shape[2])
    want = torch.autograd.grad(ref, xs, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)


def test_plain_backward_takes_d_from_the_f32_output():
    """Near-uniform attention over values that share a large mean (as in
    whisper's cross-attention): dQ = sum_k dS_k K_k leans on sum_k dS_k =
    0, which an error in D = rowsum(dO o O) breaks. From the forward's f32
    output the bf16 backward's dq stays within 1e-2 (rel L2) of f32
    autograd; from the bf16 output it is off by over 10%."""
    g = torch.Generator().manual_seed(0)
    b, h, sq, sk, d = 1, 2, 64, 1500, 64
    q = (0.3 * torch.randn(b, h, sq, d, generator=g)).bfloat16()
    k = (1 + 0.5 * torch.randn(b, h, sk, d, generator=g)).bfloat16()
    v = (4 + torch.randn(b, h, sk, d, generator=g)).bfloat16()
    do = torch.randn(b, h, sq, d, generator=g).bfloat16()
    o32, want = _autograd(*(x.float() for x in (q, k, v, do)), False, 0)
    lse = attention_lse_ref(q, k, causal=False)

    def rel(o):
        dq = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)[0]
        return ((dq.float() - want[0]).norm() / want[0].norm()).item()

    assert rel(o32) < 1e-2
    assert rel(o32.bfloat16()) > 0.1
