"""Run-plan wrappers for the LBM temporal-blocking kernel, plus the
explorer hand-off: :func:`lbm_run_for_point` runs a design point's
(block_h, m). The port of the JAX package's
``kernels/lbm_stream/ops.py``; legalization is shared with the generated
path via :mod:`repro_torch.core.legalize` (docs/pipeline.md §legalize),
and the kernel's per-step stencil reach is one row and one column."""

from __future__ import annotations

import torch

from repro_torch.core.legalize import blocking_plan, resolve_run_plan

from .lbm_stream import lbm_multistep
from .ref import lbm_multistep_ref


def lbm_run_for_point(f, attr, one_tau, point, *, steps: int | None = None,
                      u_lid=0.0):
    """Advance the lattice using a DSE design point's (block_h, m).

    The point is legalized by :func:`resolve_run_plan` (halo 1); the
    column tile is then fitted to the block's shared memory. Returns
    ``(result, (block_h, m))``.
    """
    block_h, m, nsteps, _ = resolve_run_plan(f.shape[1], point, steps)
    out = lbm_run_blocked(f, attr, one_tau, u_lid, steps=nsteps, m=m,
                          block_h=block_h)
    return out, (block_h, m)


def lbm_run_blocked(f, attr, one_tau, u_lid=0.0, *, steps: int, m: int = 4,
                    block_h: int = 32):
    """Advance ``steps`` LBM time steps in ``steps // m`` fused launches,
    ping-ponging two preallocated state tensors on the card."""
    if steps % m:
        raise ValueError(f"steps={steps} must be a multiple of m={m}")
    if steps == 0:
        return f.clone()
    bufs = None
    if f.device.type == "cuda":
        bufs = (torch.empty_like(f), torch.empty_like(f))
    cur = f
    for i in range(steps // m):
        cur = lbm_multistep(cur, attr, one_tau, u_lid, m=m, block_h=block_h,
                            out=None if bufs is None else bufs[i % 2])
    return cur


__all__ = [
    "blocking_plan",
    "lbm_multistep",
    "lbm_multistep_ref",
    "lbm_run_blocked",
    "lbm_run_for_point",
    "resolve_run_plan",
]
