"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a card. On the machine with one
(``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``)
every kernel is built from ``src/repro_torch/csrc`` and held to its plain
torch version on the same CUDA inputs. Both round the same f32 operations
in the same order (``-fmad=false``), so the comparisons are bitwise.
"""

import pytest
import torch

from repro_torch.apps import diffusion as dif
from repro_torch.apps import lbm
from repro_torch.core.legalize import tile_smem_bytes
from repro_torch.kernels.lbm_stream.lbm_stream import (
    lbm_multistep,
    lbm_multistep_plain,
)
from repro_torch.kernels.spd_stream.spd_stream import spd_multistep_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA only)")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [1, 2, 4])
def test_diffusion_kernel_equals_plain(card, m):
    sim = dif.DiffusionSimulation(64, 200)
    u0, _ = dif.sine_init(64, 200)
    st = sim.state(u0)
    want = spd_multistep_plain(sim.kernel.program, st, (0.2,), m=m,
                               block_h=16, block_w=64)
    for db in (True, False):
        got = sim.kernel(st, (0.2,), m=m, block_h=16, block_w=64,
                         double_buffer=db)
        assert torch.equal(got, want)
    assert torch.equal(sim.kernel.multistep(st, (0.2,), m=m, block_h=16,
                                            block_w=64), want)


@pytest.mark.parametrize("case", ["tgv", "couette"])
@pytest.mark.parametrize("m", [1, 4])
def test_ulbm_and_handwritten_equal_plain(card, case, m):
    sim = lbm.LBMSimulation(lbm.LBMProblem(64, 96))
    kern = sim.stream_kernel()
    if case == "tgv":
        f, attr, _ = lbm.taylor_green_init(64, 96)
        regs = (1 / 0.8, 0.0, 1.0)
    else:
        f, attr = lbm.couette_init(64, 96)
        regs = (1 / 0.9, 0.07, 1.0)
    state = sim.stream_state(f, attr)
    want = spd_multistep_plain(kern.program, state, regs, m=m, block_h=16,
                               block_w=32)
    assert torch.equal(kern(state, regs, m=m, block_h=16, block_w=32), want)
    assert torch.equal(kern.multistep(state, regs, m=m, block_h=16,
                                      block_w=32), want)
    assert torch.equal(kern(state, regs, m=m, block_h=8, block_w=48), want)
    hand = lbm_multistep(f, attr, regs[0], regs[1], m=m, block_h=16)
    assert torch.equal(hand, lbm_multistep_plain(
        f, attr, regs[0], regs[1], m=m, block_h=16, block_w=64))
    torch.testing.assert_close(want[:9], hand, rtol=2e-5, atol=1e-7)


def test_smem_pricing_equals_the_kernels(card):
    kern = lbm.LBMSimulation(lbm.LBMProblem(64, 96)).stream_kernel()
    lib = kern.program.library()
    for nbuf in (2, 3):
        assert lib.spd_smem_bytes(16, 32, 4, nbuf) == tile_smem_bytes(
            16, 32, 4, halo=1, halo_x=1, planes=kern.program.planes(nbuf))
