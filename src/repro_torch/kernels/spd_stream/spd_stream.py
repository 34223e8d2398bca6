"""The declarative launch of a generated SPD stream kernel, and the launch
body all four SPD launches share.

Replaces the JAX package's ``kernels/spd_stream/spd_stream.py:
spd_multistep`` (a Pallas grid of ``H / block_h`` programs with periodic
BlockSpec maps). Here the grid is one CUDA thread block per
``(block_h × block_w)`` tile of the kernel template every SPD launch runs:
the block loads its stripe — ``m·halo`` rows and ``m·halo_x`` columns of
guard cells per side, mod H and mod W — into shared memory, applies the
generated tile step m times (on the owned cells' state in registers for
a core that reads no state plane by stencil, on shared state otherwise)
and writes the center cells (``csrc/spd_stream.cuh``, docs/port.md
§tile). Its tile is sized so two blocks share an SM.

Bound on the card: at least ``2·P·H·W·4`` bytes of HBM traffic per launch
(each state word read once, written once); the m fused steps per round
trip are the design's answer — they raise the arithmetic per byte while
the traffic stays constant.

On a CPU tensor the launch runs :func:`spd_multistep_plain`, the torch
interpreter of the same IR over the same tiles; on a CUDA tensor it
launches the kernel or raises. The streamed launch is held to this one
bit for bit.

Both periodic launches take a ``(B, P, H, W)`` batch too (the reference's
leading axes, ``(*lead, block_h, W)`` blocks): B independent members in
one launch of ``B·(H / block_h)·ceil(W / block_w)`` tiles, each member
bitwise as it runs alone, one count on the wrapper (docs/port.md §serve).
The bound is then ``2·B·P·H·W·4`` bytes.

:func:`launch` is the one body of the four launches — periodic or over a
guard-block-extended shard (``guard``), declarative or streamed — as the
kernel source is one template: the contract checks, the column tile, the
plain version on the CPU, the device checks, the shared-memory price, the
call and the counts; on the card all but the library's lookup under the
host span ``spd.launch``, which encloses the one kernel. A launch enqueued
while a CUDA graph is captured (:func:`recording`) runs at each replay of
the graph, not at the call: the wrapper records it there and the replay
counts it (:func:`count`).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core.codegen import (
    StripeProgram,
    _check_state,
    gather_tiles,
    scatter_centers,
)
from repro_torch.tracing import span


def check_plan(program: StripeProgram, state, m: int, block_h: int) -> None:
    """The launch contract of both periodic launches, ``(P, H, W)`` or
    ``(B, P, H, W)`` (ValueError otherwise)."""
    _check_state(state, program.P, batch=True)
    h = state.shape[-2]
    if m < 1:
        raise ValueError(f"m={m} must be >= 1")
    if h % block_h:
        raise ValueError(f"H={h} must be divisible by block_h={block_h}")
    mh = m * program.halo
    if mh > block_h:
        raise ValueError(
            f"m*halo={mh} must be <= block_h={block_h} (halo source)"
        )


def check_halo(program: StripeProgram, ext, m: int, block_h: int) -> int:
    """The launch contract of both halo launches (the reference's
    ``ValueError``s); returns ``local_h``."""
    _check_state(ext, program.P)
    rows = ext.shape[1]
    local_h = rows - 2 * block_h
    if local_h < 1 or local_h % block_h:
        raise ValueError(
            f"extended shard of {rows} rows is not local_h + 2*block_h "
            f"with block_h={block_h} dividing local_h"
        )
    mh = m * program.halo
    if mh > block_h:
        raise ValueError(
            f"m*halo={mh} must be <= block_h={block_h} (halo source)"
        )
    return local_h


def _rows_contiguous(t) -> bool:
    p, rows, w = t.shape
    return t.stride(2) == 1 and t.stride(1) == w and (
        p == 1 or (t.stride(0) >= rows * w and t.stride(0) % w == 0))


def plane_rows(t) -> int:
    """Rows from one plane of ``t`` to the next (the halo kernels' plane
    stride, in rows)."""
    p, rows, w = t.shape
    return t.stride(0) // w if p > 1 else rows


def _span(t) -> tuple[int, int]:
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1
    return t.data_ptr(), t.data_ptr() + last * t.element_size()


def cuda_args(x, out, out_rows: int | None = None):
    """Device checks of a launch; returns the output tensor.

    A periodic launch (``out_rows=None``) takes a contiguous ``x``, one
    member or a batch, and writes a tensor like it. A halo launch writes
    ``(P, out_rows, W)``; there ``x`` and ``out`` need contiguous rows
    only, each plane a whole number of rows apart, so each may be a row
    range of a larger ``(P, rows', W)`` buffer (the kernels take each
    plane stride in rows).
    """
    if x.device.type != "cuda":
        raise RuntimeError(
            f"the stream kernels take CPU or CUDA tensors, got {x.device}"
        )
    if out_rows is None:
        dense, shape = torch.Tensor.is_contiguous, tuple(x.shape)
        layout = "contiguous"
    else:
        dense, shape = _rows_contiguous, (x.shape[0], out_rows, x.shape[2])
        layout = ("with contiguous rows, planes a whole number of rows "
                  "apart")
    if not dense(x):
        raise ValueError(f"the launch's input must be {layout}")
    if out is None:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    if (tuple(out.shape) != shape or out.dtype != x.dtype
            or out.device != x.device or not dense(out)):
        raise ValueError(f"out must be a {shape} f32 tensor {layout} on "
                         f"{x.device}")
    (a0, a1), (b0, b1) = _span(x), _span(out)
    if a0 < b1 and b0 < a1:
        raise ValueError("the launch is never in place: out overlaps its "
                         "input")
    return out


def deliver(res, out):
    """A plain version's result, written into ``out`` when one is given
    (the CPU path honours ``out`` as the kernel does)."""
    if out is None:
        return res
    if out.shape != res.shape or out.dtype != res.dtype or \
            out.device != res.device:
        raise ValueError(f"out must be a {tuple(res.shape)} f32 tensor on "
                         f"{res.device}")
    return out.copy_(res)


def spd_multistep_plain(program: StripeProgram, state, regs, *, m: int,
                        block_h: int, block_w: int):
    """The kernel's plain version: the IR interpreted with torch over the
    launch's ``(T, P, R, C)`` tiles, m steps, centers reassembled; a
    ``(B, P, H, W)`` batch member by member, each member the plain
    version of its ``(P, H, W)`` state."""
    if state.dim() == 4:
        return torch.stack([
            spd_multistep_plain(program, s, regs, m=m, block_h=block_h,
                                block_w=block_w) for s in state])
    _, h, w = state.shape
    mh, mw = m * program.halo, m * program.halo_x
    tiles = gather_tiles(state, block_h, block_w, mh, mw)
    for _ in range(m):
        tiles = program.run(tiles, regs)
    return scatter_centers(tiles, h, w, block_h, block_w, mh, mw)


def spd_multistep_halo_plain(program: StripeProgram, ext, regs, *, m: int,
                             block_h: int, block_w: int):
    """The halo launches' plain version: the IR interpreted with torch over
    the launch's tiles (ext rows without wrap, columns mod W), m steps,
    the ``local_h`` rows of centers reassembled."""
    _, rows, w = ext.shape
    mh, mw = m * program.halo, m * program.halo_x
    tiles = gather_tiles(ext, block_h, block_w, mh, mw, guard=True)
    for _ in range(m):
        tiles = program.run(tiles, regs)
    return scatter_centers(tiles, rows - 2 * block_h, w, block_h, block_w,
                           mh, mw)


#: This thread's launches recorded during a CUDA-graph capture, or None.
_capture = threading.local()


@contextlib.contextmanager
def recording():
    """Record, instead of counting, the launches this thread's wrappers
    enqueue while a CUDA graph is captured. Yields the list of
    ``(wrapper, core name)`` the graph launches at each replay; the replay
    passes each to :func:`count`."""
    prev = getattr(_capture, "launches", None)
    _capture.launches = rec = []
    try:
        yield rec
    finally:
        _capture.launches = prev


def count(fn, name: str) -> None:
    """Count one launch of wrapper ``fn``'s kernel of core ``name``, in
    the wrapper's and the stripe body's counts, or record it inside
    :func:`recording`."""
    rec = getattr(_capture, "launches", None)
    if rec is not None:
        rec.append((fn, name))
        return
    fn.launches += 1
    StripeProgram.count_launch(name)


def launch(fn, program: StripeProgram, x, regs, *, m: int, block_h: int,
           block_w: int | None, double_buffer: bool, out, guard: bool):
    """The body of the four SPD launches.

    ``fn`` is the public wrapper: its name is the kernel's ``extern "C"``
    entry point, and its ``launches`` counts the kernel's launches. A
    streamed wrapper (named ``*_streamed``) takes ``double_buffer``; a
    declarative one passes False. ``guard`` launches over a
    guard-block-extended shard: ext rows without wrap, ``rows - 2·block_h``
    output rows, row-range tensors allowed. ``block_w=None`` takes the
    plan of :meth:`StripeProgram.tile`: the widest column tile that
    leaves room for two blocks on an SM — a streamed launch prefetching
    when that tile fits at that width and, for a register-state core,
    when the owners hold its stripe — and the one-block rule only when no
    tile does. The tile is one member's: a periodic launch of a ``(B,
    P, H, W)`` batch has B times the tiles, each block's shared memory
    that of one member's tile.
    """
    streamed = fn.__name__.endswith("_streamed")
    if guard:
        out_rows = check_halo(program, x, m, block_h)
    else:
        check_plan(program, x, m, block_h)
        out_rows = None
    rows, w = x.shape[-2:]
    if x.device.type == "cpu":
        block_w, _ = program.tile(w, block_h, m, block_w=block_w,
                                  double_buffer=double_buffer,
                                  streamed=streamed)
        plain = spd_multistep_halo_plain if guard else spd_multistep_plain
        return deliver(plain(program, x, regs, m=m, block_h=block_h,
                             block_w=block_w), out)
    from repro_torch.kernels.build import check, spd_regs

    # The library is built or loaded outside the span: a set-up phase.
    lib = program.library() if x.device.type == "cuda" else None
    with span("spd.launch"):
        block_w, double_buffer = program.tile(
            w, block_h, m, block_w=block_w, double_buffer=double_buffer,
            streamed=streamed)
        out = cuda_args(x, out, out_rows)
        smem = program.smem_bytes(block_h, block_w, m, streamed=streamed,
                                  double_buffer=double_buffer)
        args = [x.data_ptr(), out.data_ptr()]
        if guard:
            args += [rows, w, plane_rows(x), plane_rows(out)]
        else:
            args += [x.shape[0] if x.dim() == 4 else 1, rows, w]
        args += [block_h, block_w, m]
        if streamed:
            args.append(int(double_buffer))
        with torch.cuda.device(x.device):
            check(getattr(lib, fn.__name__)(
                *args, spd_regs(regs), smem, x.device.index,
                torch.cuda.current_stream(x.device).cuda_stream,
            ), fn.__name__)
        count(fn, program.name)
    return out


def spd_multistep(program: StripeProgram, state, regs, *, m: int,
                  block_h: int, block_w: int | None = None, out=None):
    """Fused m-step launch, one thread block per tile.

    ``state`` is ``(P, H, W)`` or a ``(B, P, H, W)`` batch (one launch of
    every member's tiles). ``regs`` are the Append_Reg values (floats, in
    ``core.regs`` order), shared by every member.
    ``block_w=None`` takes the widest column tile whose two-buffer tile
    fits the block's shared memory.
    """
    return launch(spd_multistep, program, state, regs, m=m, block_h=block_h,
                  block_w=block_w, double_buffer=False, out=out, guard=False)


spd_multistep.launches = 0
