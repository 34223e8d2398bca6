"""The declarative launch over one shard of a device mesh.

Replaces the JAX package's ``kernels/spd_stream/sharded.py:
spd_multistep_halo`` (a Pallas grid of ``local_h / block_h`` programs with
the non-periodic BlockSpec maps ``(0, i + 1 + off, 0)``). Under spatial
parallelism (:mod:`repro_torch.core.distribute`, docs/port.md
§distribute) each device holds one shard, and before every fused launch
the neighbours' boundary rows are exchanged into a guard-block-extended
shard

    ``ext = [pad | up-halo | local rows | down-halo | pad]``

of ``local_h + 2·block_h`` rows. Here one CUDA thread block per output
tile loads its stripe from ext rows ``(by + 1)·block_h - m·halo ...`` —
no row is wrapped, the guard blocks supply every row a stripe reads —
and columns mod ext's width, applies the same generated tile function as
every other launch m times, and writes ``(P, local_h, W)``
(``csrc/spd_stream.cuh``). Under a column-sharded mesh W is the shard's
width plus ``2·m·halo_x`` exchanged guard columns; the columns that a
wrapped guard reaches are the ones the caller crops.

ext and the output need contiguous rows only: each may be a row range of
a larger ``(P, rows', W)`` buffer (the kernels take each plane stride in
rows), so the sharded run launches on its guard-extended buffers in place
of copies. Bound on the card: at least ``4·P·(rows + local_h)·W`` bytes
of HBM traffic per launch; m fused steps per round trip are the design's
answer.

On a CPU tensor the launch runs :func:`spd_multistep_halo_plain`; on a
CUDA tensor it launches the kernel or raises. The streamed twin
(:func:`repro_torch.kernels.spd_stream.streaming
.spd_multistep_halo_streamed`) is held to this one bit for bit.
"""

from __future__ import annotations

from repro_torch.core.codegen import StripeProgram, _check_state

from .spd_stream import (
    check_halo,
    launch,
    spd_multistep,
    spd_multistep_halo_plain,
)

__all__ = ["check_halo", "spd_multistep_halo", "spd_multistep_halo_plain"]


def spd_multistep_halo(program: StripeProgram, ext, regs, *, m: int,
                       block_h: int, block_w: int | None = None, out=None):
    """Fused m-step launch over one guard-block-extended shard.

    ``ext`` is ``(P, local_h + 2·block_h, W)``; returns the advanced
    ``(P, local_h, W)`` shard (into ``out`` when given). A core with no
    y reach (``m·halo == 0``) needs no guard blocks and takes the
    periodic :func:`spd_multistep`. A shard is one member: a ``(B, P, H,
    W)`` batch raises.
    """
    _check_state(ext, program.P)
    if m * program.halo == 0:
        return spd_multistep(program, ext, regs, m=m, block_h=block_h,
                             block_w=block_w, out=out)
    return launch(spd_multistep_halo, program, ext, regs, m=m,
                  block_h=block_h, block_w=block_w, double_buffer=False,
                  out=out, guard=True)


spd_multistep_halo.launches = 0
