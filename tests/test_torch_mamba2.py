"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's on the CPU: the same numpy inputs, JAX-initialized parameters
copied across.

Every comparison is f32 at small widths: the port runs the reference's
operations in the reference's order of casts and differs only in how
torch and XLA sum, so ``LAYER_TOL`` is a small multiple of f32 rounding.
The chunked-vs-sequential checks mirror ``tests/test_models.py`` at its
tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import SSMConfig as JaxSSM
from repro.models import mamba2 as jm
from repro_torch.configs import get_arch
from repro_torch.configs.base import SSMConfig
from repro_torch.models import mamba2 as tm

#: One layer's activations and states, f32.
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
#: Chunked scan against the step-by-step recurrence
#: (tests/test_models.py::test_mamba2_chunked_equals_sequential).
SCAN_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfgs(chunk=8, head_dim=16, state=16, d_model=96, n_groups=1):
    """tests/test_models.py's Mamba2 config, in both packages."""
    kw = dict(state=state, head_dim=head_dim, expand=2, conv=4, chunk=chunk,
              n_groups=n_groups)
    jc = dataclasses.replace(jax_get_arch("zamba2-7b").reduced(),
                             d_model=d_model, ssm=JaxSSM(**kw))
    tc = dataclasses.replace(get_arch("zamba2-7b").reduced(),
                             d_model=d_model, ssm=SSMConfig(**kw))
    return jc, tc


def _layer(jc, tc, seed=0):
    """JAX's ``mamba2_init`` params and a port ``Mamba2`` holding them."""
    p = jm.mamba2_init(jc, jax.random.PRNGKey(seed))
    layer = tm.Mamba2(tc)
    with torch.no_grad():
        for name, value in p.items():
            getattr(layer, name).copy_(torch.from_numpy(np.array(value)))
    return p, layer


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_init_distributions_and_dtypes():
    """``init_weights`` draws ``mamba2_init``'s distributions; the decay
    parameters stay f32 in a bf16 model."""
    tc = dataclasses.replace(get_arch("zamba2-7b").reduced(), d_model=256,
                             dtype="bfloat16")
    layer = tm.Mamba2(tc)
    layer.init_weights(tc, torch.Generator().manual_seed(0))
    assert layer.in_proj.dtype == torch.bfloat16
    assert {layer.A_log.dtype, layer.D.dtype, layer.dt_bias.dtype} == {
        torch.float32}
    std = float(layer.in_proj.float().std()) * tc.d_model ** 0.5
    assert abs(std - 1.0) < 0.05
    assert abs(float(layer.conv_w.float().std()) * 2.0 - 1.0) < 0.1
    assert not layer.A_log.any() and not layer.dt_bias.any()
    assert torch.equal(layer.D, torch.ones_like(layer.D))


@pytest.mark.parametrize("s", [1, 3, 10])
def test_causal_conv(s):
    x, w, b = _x(0, 2, s, 24), _x(1, 4, 24), _x(2, 24)
    got = tm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, jm._causal_conv(*map(jnp.asarray, (x, w, b))), LAYER_TOL)


@pytest.mark.parametrize("n_groups,with_h0", [(1, False), (2, True)])
def test_ssd_chunked(n_groups, with_h0):
    """Heads != chunk length, groups broadcast to heads, an initial
    state; the final state too."""
    jc, _ = _cfgs(chunk=8)
    b, S, H, P, N = 2, 24, 6, 4, 5
    xh, dt = _x(0, b, S, H, P), np.abs(_x(1, b, S, H))
    dA = -dt * np.abs(_x(2, H))
    Bm, Cm = _x(3, b, S, n_groups, N), _x(4, b, S, n_groups, N)
    h0 = _x(5, b, H, P, N) if with_h0 else None
    args = (xh, dt, dA, Bm, Cm)
    y, h = tm._ssd_chunked(*map(torch.from_numpy, args), jc.ssm,
                           None if h0 is None else torch.from_numpy(h0))
    jy, jh = jm._ssd_chunked(*map(jnp.asarray, args), jc.ssm,
                             None if h0 is None else jnp.asarray(h0))
    _close(y, jy, LAYER_TOL)
    _close(h, jh, LAYER_TOL)


def test_ssd_chunked_gradient_is_finite_past_exp_overflow():
    """A chunk whose decay passes exp's f32 range (cum down to ~ -230 over
    128 steps, as Zamba2-7B's bf16 training step on the card reaches): the
    output and its gradient with respect to every input equal autograd
    through the step-by-step recurrence, the gradient finite (masking
    exp's result left NaN there)."""
    jc, _ = _cfgs(chunk=128)
    b, S, H, P, N = 1, 256, 2, 4, 3
    xh, Bm, Cm = _x(0, b, S, H, P), _x(1, b, S, 1, N), _x(2, b, S, 1, N)
    dt = 1.0 + np.abs(_x(3, b, S, H))
    dA = -dt
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (xh, dt, dA, Bm, Cm)]
    y, _ = tm._ssd_chunked(*args, jc.ssm)
    go = torch.from_numpy(_x(4, b, S, H, P))
    got = torch.autograd.grad(y, args, go)

    def sequential(xh, dt, dA, Bm, Cm):
        h, ys = torch.zeros((b, H, P, N)), []
        for t in range(S):
            u = (xh[:, t] * dt[:, t, :, None])[..., None] * Bm[:, t, :, None]
            h = h * torch.exp(dA[:, t])[..., None, None] + u
            ys.append(torch.einsum("bhpn,bgn->bhp", h, Cm[:, t]))
        return torch.stack(ys, dim=1)

    seq = sequential(*args)
    torch.testing.assert_close(y, seq, **SCAN_TOL)
    want = torch.autograd.grad(seq, args, go)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **SCAN_TOL)


def test_ssd_chunked_rejects_an_untiled_sequence():
    jc, _ = _cfgs(chunk=8)
    args = [torch.zeros((1, 12, 2, 4)), torch.zeros((1, 12, 2)),
            torch.zeros((1, 12, 2)), torch.zeros((1, 12, 1, 3)),
            torch.zeros((1, 12, 1, 3))]
    with pytest.raises(ValueError, match="must tile by chunk 8"):
        tm._ssd_chunked(*args, jc.ssm)


def test_mamba2_apply():
    jc, tc = _cfgs(chunk=8)
    p, layer = _layer(jc, tc)
    x = _x(0, 2, 32, tc.d_model)
    _close(tm.mamba2_apply(layer, torch.from_numpy(x), tc),
           jm.mamba2_apply(p, jnp.asarray(x), jc), LAYER_TOL)


def test_mamba2_decode():
    """Eight steps from a zero state: each step's output and the final
    ``h`` and ``conv`` state equal JAX's."""
    jc, tc = _cfgs(chunk=8)
    p, layer = _layer(jc, tc, seed=3)
    x = _x(1, 2, 8, tc.d_model)
    st = tm.mamba2_state_init(tc, 2)
    jst = jm.mamba2_state_init(jc, 2)
    for t in range(8):
        y, st = tm.mamba2_decode(layer, torch.from_numpy(x[:, t:t + 1]), tc,
                                 st)
        jy, jst = jm.mamba2_decode(p, jnp.asarray(x[:, t:t + 1]), jc, jst)
        _close(y, jy, LAYER_TOL)
    _close(st["h"], jst["h"], LAYER_TOL)
    _close(st["conv"], jst["conv"], LAYER_TOL)


@pytest.mark.parametrize("chunk,s", [(8, 32), (16, 16), (4, 24)])
def test_chunked_equals_sequential(chunk, s):
    """Heads != chunk length on purpose (catches axis-order bugs)."""
    jc, tc = _cfgs(chunk=chunk)
    _, layer = _layer(jc, tc)
    x = torch.from_numpy(_x(0, 2, s, tc.d_model))
    full = tm.mamba2_apply(layer, x, tc)
    st = tm.mamba2_state_init(tc, 2)
    ys = []
    for t in range(s):
        y, st = tm.mamba2_decode(layer, x[:, t:t + 1], tc, st)
        ys.append(y[:, 0])
    torch.testing.assert_close(full, torch.stack(ys, dim=1), **SCAN_TOL)


def test_chunk_boundary_invariance():
    jc8, tc8 = _cfgs(chunk=8)
    _, tc16 = _cfgs(chunk=16)
    _, layer = _layer(jc8, tc8, seed=1)
    x = torch.from_numpy(_x(1, 1, 32, tc8.d_model))
    torch.testing.assert_close(tm.mamba2_apply(layer, x, tc8),
                               tm.mamba2_apply(layer, x, tc16), **SCAN_TOL)


def test_decode_rows_leave_the_other_rows_alone():
    """``rows=[1]`` writes row 1's new state and no other; its output and
    state equal the all-rows step's."""
    jc, tc = _cfgs(chunk=8)
    _, layer = _layer(jc, tc)
    x = torch.from_numpy(_x(2, 3, 1, tc.d_model))

    def state():
        g = torch.Generator().manual_seed(4)
        st = tm.mamba2_state_init(tc, 3)
        return {k: torch.randn(v.shape, generator=g) for k, v in st.items()}

    before = state()
    y_all, full = tm.mamba2_decode(layer, x, tc, state())
    y_row, part = tm.mamba2_decode(layer, x, tc, state(),
                                   rows=torch.tensor([1]))
    assert torch.equal(y_row, y_all)
    for key in ("h", "conv"):
        assert torch.equal(part[key][1], full[key][1])
        assert not torch.equal(part[key][1], before[key][1])
        assert torch.equal(part[key][[0, 2]], before[key][[0, 2]])
