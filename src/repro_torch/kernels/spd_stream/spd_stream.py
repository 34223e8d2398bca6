"""The declarative launch of a generated SPD stream kernel.

Replaces the JAX package's ``kernels/spd_stream/spd_stream.py:
spd_multistep`` (a Pallas grid of ``H / block_h`` programs with periodic
BlockSpec maps). Here the grid is one CUDA thread block per
``(block_h × block_w)`` tile: the block loads its stripe — ``m·halo`` rows
and ``m·halo_x`` columns of guard cells per side, mod H and mod W — into
shared memory, applies the generated tile function m times and writes the
center cells (``csrc/spd_stream.cuh``, docs/port.md §tile).

Bound on the card: at least ``2·P·H·W·4`` bytes of HBM traffic per launch
(each state word read once, written once); the m fused steps per round
trip are the design's answer — they raise the arithmetic per byte while
the traffic stays constant.

On a CPU tensor the launch runs :func:`spd_multistep_plain`, the torch
interpreter of the same IR over the same tiles; on a CUDA tensor it
launches the kernel or raises. The streamed launch is held to this one
bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.codegen import (
    StripeProgram,
    _check_state,
    gather_tiles,
    scatter_centers,
)
from repro_torch.core.legalize import launch_tile, tile_smem_bytes


def check_plan(program: StripeProgram, state, m: int, block_h: int) -> None:
    """The launch contract of both SPD launches (ValueError otherwise)."""
    _check_state(state, program.P)
    h = state.shape[1]
    if m < 1:
        raise ValueError(f"m={m} must be >= 1")
    if h % block_h:
        raise ValueError(f"H={h} must be divisible by block_h={block_h}")
    mh = m * program.halo
    if mh > block_h:
        raise ValueError(
            f"m*halo={mh} must be <= block_h={block_h} (halo source)"
        )


def cuda_args(state, out):
    """Device checks of a launch; returns the output tensor."""
    if state.device.type != "cuda":
        raise RuntimeError(
            f"the stream kernels take CPU or CUDA tensors, got {state.device}"
        )
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if out is None:
        return torch.empty_like(state)
    if (out.shape != state.shape or out.dtype != state.dtype
            or out.device != state.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous f32 tensor like state")
    if out.data_ptr() == state.data_ptr():
        raise ValueError("the launch is never in place: out aliases state")
    return out


def spd_multistep_plain(program: StripeProgram, state, regs, *, m: int,
                        block_h: int, block_w: int):
    """The kernel's plain version: the IR interpreted with torch over the
    launch's ``(T, P, R, C)`` tiles, m steps, centers reassembled."""
    _, h, w = state.shape
    mh, mw = m * program.halo, m * program.halo_x
    tiles = gather_tiles(state, block_h, block_w, mh, mw)
    for _ in range(m):
        tiles = program.run(tiles, regs)
    return scatter_centers(tiles, h, w, block_h, block_w, mh, mw)


def spd_multistep(program: StripeProgram, state, regs, *, m: int,
                  block_h: int, block_w: int | None = None, out=None):
    """Fused m-step launch, one thread block per tile.

    ``regs`` are the Append_Reg values (floats, in ``core.regs`` order).
    ``block_w=None`` takes the widest column tile whose two-buffer tile
    fits the block's shared memory.
    """
    check_plan(program, state, m, block_h)
    _, h, w = state.shape
    block_w, _ = launch_tile(
        w, block_h, m, halo=program.halo, halo_x=program.halo_x,
        planes=lambda db: program.planes(2), block_w=block_w,
        double_buffer=False,
    )
    if state.device.type == "cpu":
        return spd_multistep_plain(program, state, regs, m=m,
                                   block_h=block_h, block_w=block_w)
    from repro_torch.kernels.build import check, spd_regs

    out = cuda_args(state, out)
    smem = tile_smem_bytes(block_h, block_w, m, halo=program.halo,
                           halo_x=program.halo_x, planes=program.planes(2))
    lib = program.library()
    check(lib.spd_multistep(
        state.data_ptr(), out.data_ptr(), h, w, block_h, block_w, m,
        spd_regs(regs), smem,
        torch.cuda.current_stream(state.device).cuda_stream,
    ), "spd_multistep")
    spd_multistep.launches += 1
    StripeProgram.count_launch(program.name)
    return out


spd_multistep.launches = 0
