"""Run-plan wrappers for generated SPD stream kernels.

The port of the JAX package's ``kernels/spd_stream/ops.py``: multi-launch
stepping over the fused kernel, with (block_h, m) plans legalized through
the copied :mod:`repro_torch.core.legalize` (docs/pipeline.md §legalize).
The kernel-building side lives in
:class:`repro_torch.core.codegen.StreamKernel`.
"""

from __future__ import annotations

import torch

from repro_torch.core.codegen import StripeProgram
from repro_torch.core.legalize import blocking_plan, resolve_run_plan
from repro_torch.tracing import span

from .sharded import spd_multistep_halo
from .spd_stream import spd_multistep
from .streaming import spd_multistep_halo_streamed, spd_multistep_streamed


def stream_run_blocked(program: StripeProgram, state, regs, *, steps: int,
                       m: int, block_h: int, double_buffer: bool = True):
    """Advance ``steps`` time steps in ``steps // m`` streamed launches.

    On the card the launches ping-pong between two preallocated state
    tensors (a launch never writes in place); the input is not modified.
    A ``(B, P, H, W)`` batch ping-pongs two batches, one launch a fused
    step for every member.
    """
    if steps % m:
        raise ValueError(f"steps={steps} must be a multiple of m={m}")
    if steps == 0:
        return state.clone()
    bufs = None
    if state.device.type == "cuda":
        with span("stream.alloc"):
            bufs = (torch.empty_like(state), torch.empty_like(state))
    cur = state
    for i in range(steps // m):
        cur = spd_multistep_streamed(
            program, cur, regs, m=m, block_h=block_h,
            double_buffer=double_buffer,
            out=None if bufs is None else bufs[i % 2],
        )
    return cur


__all__ = [
    "blocking_plan",
    "resolve_run_plan",
    "spd_multistep",
    "spd_multistep_halo",
    "spd_multistep_halo_streamed",
    "spd_multistep_streamed",
    "stream_run_blocked",
]
