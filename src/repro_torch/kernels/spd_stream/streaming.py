"""The streamed launch of a generated SPD stream kernel.

Replaces the JAX package's ``kernels/spd_stream/streaming.py:
spd_multistep_streamed`` (one Pallas program walking the row blocks with
manual ping/pong DMA into VMEM, docs/pipeline.md §stream). On Hopper,
persistent thread blocks — the kernel's occupancy times the SM count —
walk the ``(block_h × block_w)`` tiles. With ``double_buffer`` each block
prefetches its next tile's stripe with 16-byte ``cp.async`` copies while
the current tile computes: into the one load slot once the owners have
read it into registers (a core that reads no state plane by stencil,
such as the uLBM PE), else into a second ring slot; without it one slot
is loaded, computed and written in turn (``csrc/spd_stream.cuh``,
docs/port.md §tile). The default plan seeks room for two blocks per SM
first: the uLBM PE runs 16×32 tiles at two blocks per SM, diffusion
32×128 with two slots at three.

Bound on the card: at least ``2·P·H·W·4`` bytes of HBM traffic per launch;
m fused steps per round trip, and the prefetch that overlaps the next
tile's loads with this tile's arithmetic, are the design's answers.

Both protocols run the same generated tile function as the declarative
launch, so all three are bitwise identical. On a CPU tensor the launch
runs the shared plain version.

:func:`spd_multistep_halo_streamed` is the same walk over one
guard-block-extended shard of a device mesh (docs/port.md §distribute),
the twin of :func:`repro_torch.kernels.spd_stream.sharded
.spd_multistep_halo`.
"""

from __future__ import annotations

from repro_torch.core.codegen import StripeProgram, _check_state

from .spd_stream import launch


def spd_multistep_streamed(program: StripeProgram, state, regs, *, m: int,
                           block_h: int, block_w: int | None = None,
                           double_buffer: bool = True, out=None):
    """Streamed fused m-step launch, periodic in y and x.

    ``state`` is ``(P, H, W)`` or a ``(B, P, H, W)`` batch: the persistent
    blocks walk every member's tiles in one launch, the prefetch crossing
    from one member to the next. Same contract and bitwise the same
    result as
    :func:`repro_torch.kernels.spd_stream.spd_stream.spd_multistep`.
    With ``block_w=None``, ``double_buffer`` drops to the single-buffer
    protocol when the widest tile with room for two blocks per SM fits
    only without the prefetch slot, when no prefetching tile fits, or
    when a register-state core's stripe exceeds the owners' cells
    (:meth:`StripeProgram.tile`).
    """
    return launch(spd_multistep_streamed, program, state, regs, m=m,
                  block_h=block_h, block_w=block_w,
                  double_buffer=double_buffer, out=out, guard=False)


spd_multistep_streamed.launches = 0


def spd_multistep_halo_streamed(program: StripeProgram, ext, regs, *,
                                m: int, block_h: int,
                                block_w: int | None = None,
                                double_buffer: bool = True, out=None):
    """Streamed fused m-step launch over one guard-block-extended shard.

    The streamed twin of
    :func:`repro_torch.kernels.spd_stream.sharded.spd_multistep_halo`
    (replaces the JAX package's ``kernels/spd_stream/streaming.py:
    spd_multistep_halo_streamed``): ``ext`` is the ``(P, local_h +
    2·block_h, W)`` shard, output block i's stripe is ext rows ``(i +
    1)·block_h - m·halo ...`` with no wrap, and persistent blocks walk the
    tiles with the same ``cp.async`` prefetch as
    :func:`spd_multistep_streamed`. Same contract, errors and bits as the
    declarative launch; ``m·halo == 0`` takes the periodic streamed
    launch. A shard is one member: a ``(B, P, H, W)`` batch raises.
    """
    _check_state(ext, program.P)
    if m * program.halo == 0:
        return spd_multistep_streamed(
            program, ext, regs, m=m, block_h=block_h, block_w=block_w,
            double_buffer=double_buffer, out=out,
        )
    return launch(spd_multistep_halo_streamed, program, ext, regs, m=m,
                  block_h=block_h, block_w=block_w,
                  double_buffer=double_buffer, out=out, guard=True)


spd_multistep_halo_streamed.launches = 0
