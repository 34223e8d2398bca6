"""The streamed launch of a generated SPD stream kernel.

Replaces the JAX package's ``kernels/spd_stream/streaming.py:
spd_multistep_streamed`` (one Pallas program walking the row blocks with
manual ping/pong DMA into VMEM, docs/pipeline.md §stream). On Hopper,
persistent thread blocks — the kernel's occupancy times the SM count —
walk the ``(block_h × block_w)`` tiles. With ``double_buffer`` each block
prefetches its next tile's stripe into a second shared-memory buffer with
``cp.async`` while the current tile computes; without it one buffer is
loaded, computed and written in turn (``csrc/spd_stream.cuh``,
docs/port.md §tile).

Bound on the card: at least ``2·P·H·W·4`` bytes of HBM traffic per launch;
m fused steps per round trip, and the prefetch that overlaps the next
tile's loads with this tile's arithmetic, are the design's answers.

Both protocols run the same generated tile function as the declarative
launch, so all three are bitwise identical. On a CPU tensor the launch
runs the shared plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.codegen import StripeProgram
from repro_torch.core.legalize import launch_tile, tile_smem_bytes

from .spd_stream import check_plan, cuda_args, spd_multistep_plain


def spd_multistep_streamed(program: StripeProgram, state, regs, *, m: int,
                           block_h: int, block_w: int | None = None,
                           double_buffer: bool = True, out=None):
    """Streamed fused m-step launch, periodic in y and x.

    Same contract and bitwise the same result as
    :func:`repro_torch.kernels.spd_stream.spd_stream.spd_multistep`.
    ``double_buffer`` drops to the single-buffer protocol when no
    prefetching tile fits the block's shared memory.
    """
    check_plan(program, state, m, block_h)
    _, h, w = state.shape
    block_w, double_buffer = launch_tile(
        w, block_h, m, halo=program.halo, halo_x=program.halo_x,
        planes=lambda db: program.planes(3 if db else 2), block_w=block_w,
        double_buffer=double_buffer,
    )
    if state.device.type == "cpu":
        return spd_multistep_plain(program, state, regs, m=m,
                                   block_h=block_h, block_w=block_w)
    from repro_torch.kernels.build import check, spd_regs

    out = cuda_args(state, out)
    planes = program.planes(3 if double_buffer else 2)
    smem = tile_smem_bytes(block_h, block_w, m, halo=program.halo,
                           halo_x=program.halo_x, planes=planes)
    lib = program.library()
    check(lib.spd_multistep_streamed(
        state.data_ptr(), out.data_ptr(), h, w, block_h, block_w, m,
        int(double_buffer), spd_regs(regs), smem,
        torch.cuda.current_stream(state.device).cuda_stream,
    ), "spd_multistep_streamed")
    spd_multistep_streamed.launches += 1
    StripeProgram.count_launch(program.name)
    return out


spd_multistep_streamed.launches = 0
