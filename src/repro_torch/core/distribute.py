"""Spatial parallelism for stream kernels: the device mesh, on PyTorch.

The port of the JAX package's ``core/distribute.py`` (docs/pipeline.md
§distribute, DESIGN.md §8 and §15; the port's design is docs/port.md
§distribute). The paper duplicates pipelines for spatial parallelism;
this module duplicates them across devices. A generated
:class:`~repro_torch.core.codegen.StreamKernel`'s ``(P, H, W)`` grid is cut
over a ``(dy, dx)`` mesh: rows into ``dy`` equal shards (the ring axis
:data:`DEVICE_AXIS`), columns into ``dx`` (:data:`DEVICE_AXIS_X`), and
every shard runs the same fused m-step launch on its ``(H/dy, W/dx)``
shard, after exchanging its boundary with its mesh neighbours. Both axes
are rings, which closes the grid's periodic boundary across shards.

The mesh is a device *list*, driven by one controller, as the reference's
``shard_map`` over a JAX mesh is. A list may repeat a device:
``["cuda:0"] * 4`` runs a (2, 2) mesh on one card and ``["cpu"] * 4`` on
the CPU — the counterpart of XLA's forced host devices — and every halo
launch, exchange and crop then runs for real. Shards live on their
devices; the exchange is ``copy_`` of slices (a peer copy between two
cards, a device copy on a repeated one).

Per fused launch (:meth:`ShardedStreamKernel.run_blocked`):

1. the column exchange (``dx > 1``): each shard receives its left and
   right neighbours' ``m·halo_x`` edge columns as guard columns;
2. the row exchange, first hop: its up and down neighbours' ``m·halo``
   edge rows as guard rows, at the shard's own width;
3. the corner second hop (``dx > 1``): the edges of the left and right
   neighbours' *received* guard rows, which are the diagonal
   neighbours' ``(m·halo, m·halo_x)`` corners — two hops, so that each
   link carries the volumes the DSE model prices;
4. one halo launch per shard
   (:func:`repro_torch.kernels.spd_stream.streaming
   .spd_multistep_halo_streamed`) over ``[pad | up | cur | dn | pad]``.
   Its columns are loaded mod the extended width: a wrapped guard column
   reaches at most ``m·halo_x - 1`` columns inward, which are the guard
   columns cropped away, so the kept columns agree exactly.

Every shard is kept in two guard-extended buffers (:class:`ShardBuffers`):
a launch reads one and writes the other's center rows, so no shard is
ever copied whole and only boundary slices move. Each block's stripe
holds the same values as on one device, and every launch runs the same
generated tile function, so a sharded run equals the single-device run
bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.interop import resolve_devices

from .codegen import _check_state, count_plan
from .legalize import mesh_shape, resolve_run_plan, shard_height, shard_width

#: Name of the row device axis (the ring axis).
DEVICE_AXIS = "d"

#: Name of the column device axis of the 2-D mesh.
DEVICE_AXIS_X = "dx"

__all__ = [
    "DEVICE_AXIS",
    "DEVICE_AXIS_X",
    "ShardBuffers",
    "ShardedStreamKernel",
    "device_axis_values",
    "device_mesh",
    "mesh_axis_values",
    "ring_mesh",
]


def device_axis_values(max_d: int) -> tuple[int, ...]:
    """Powers of two up to ``max_d`` — the default sweep of the d axis."""
    if max_d < 1:
        raise ValueError(f"max_d must be >= 1, got {max_d}")
    vals = []
    v = 1
    while v <= max_d:
        vals.append(v)
        v *= 2
    return tuple(vals)


def mesh_axis_values(max_d: int) -> tuple[tuple[int, int], ...]:
    """Every power-of-two mesh shape ``(dy, dx)`` with ``dy·dx <= max_d``
    (``(d, 1)`` shapes are the 1-D rings)."""
    return tuple(
        (dy, dx)
        for dy in device_axis_values(max_d)
        for dx in device_axis_values(max_d)
        if dy * dx <= max_d
    )


def ring_mesh(d: int, devices: Sequence | None = None) -> list:
    """The ``d`` devices of a ring along :data:`DEVICE_AXIS`: shard i
    exchanges with shards (i±1) mod d. ``devices`` as in
    :func:`repro_torch.interop.resolve_devices`; too few raise."""
    if d < 1:
        raise ValueError(f"device axis must be >= 1, got d={d}")
    return resolve_devices(devices, d)


def device_mesh(dy: int, dx: int, devices: Sequence | None = None) -> list:
    """A ``(dy, dx)`` mesh as ``dy`` rows of ``dx`` devices; rows shard
    over :data:`DEVICE_AXIS`, columns over :data:`DEVICE_AXIS_X`."""
    if dy < 1 or dx < 1:
        raise ValueError(f"mesh axes must be >= 1, got (dy={dy}, dx={dx})")
    devs = resolve_devices(devices, dy * dx)
    return [devs[i * dx:(i + 1) * dx] for i in range(dy)]


class ShardBuffers:
    """The shards of one run, each in two guard-extended buffers on its
    device (docs/port.md §distribute).

    Buffer ``(i, j)`` is ``(P, local_h + 2·g, local_w + 2·mhx)``: ``g =
    block_h`` guard rows per side when the core reads in y (``mh > 0``,
    else 0; only the inner ``mh`` are ever filled or read) and ``mhx``
    guard columns per side under a column-sharded mesh. The shard is the
    center ``[:, g:g+local_h, mhx:mhx+local_w]``. The exchange copies
    neighbours' center slices into this shard's guards; a launch reads
    :meth:`src` and writes :meth:`dst`'s center rows, then :meth:`swap`.
    """

    def __init__(self, state, grid, *, block_h: int, mh: int, mhx: int):
        p, h, w = state.shape
        self.dy, self.dx = len(grid), len(grid[0])
        self.lh, self.lw = h // self.dy, w // self.dx
        self.mh, self.mhx = mh, mhx
        self.g = block_h if mh else 0
        shape = (p, self.lh + 2 * self.g, self.lw + 2 * mhx)
        self.bufs = {}
        for i in range(self.dy):
            for j in range(self.dx):
                a = torch.zeros(shape, dtype=state.dtype, device=grid[i][j])
                self.center(a).copy_(state[:, i * self.lh:(i + 1) * self.lh,
                                           j * self.lw:(j + 1) * self.lw])
                self.bufs[i, j] = (a, torch.zeros_like(a))
        self.cur = 0

    def center(self, buf):
        return buf[:, self.g:self.g + self.lh, self.mhx:self.mhx + self.lw]

    def src(self, i: int, j: int):
        return self.bufs[i % self.dy, j % self.dx][self.cur]

    def dst(self, i: int, j: int):
        return self.bufs[i % self.dy, j % self.dx][1 - self.cur]

    def swap(self) -> None:
        self.cur = 1 - self.cur

    def exchange_x(self) -> None:
        """Column guards from the left and right neighbours' centers."""
        mhx, lw = self.mhx, self.lw
        if not mhx:
            return
        rows = slice(self.g, self.g + self.lh)
        for i, j in self.bufs:
            e = self.src(i, j)
            e[:, rows, :mhx].copy_(self.src(i, j - 1)[:, rows, lw:lw + mhx])
            e[:, rows, mhx + lw:].copy_(
                self.src(i, j + 1)[:, rows, mhx:2 * mhx])

    def exchange_y(self) -> None:
        """Row guards from the up and down neighbours (first hop), then
        the corners from the left and right neighbours' received row
        guards (second hop)."""
        g, lh, mh, mhx, lw = self.g, self.lh, self.mh, self.mhx, self.lw
        if not mh:
            return
        cols = slice(mhx, mhx + lw)
        up, dn = slice(g - mh, g), slice(g + lh, g + lh + mh)
        for i, j in self.bufs:
            e = self.src(i, j)
            e[:, up, cols].copy_(self.src(i - 1, j)[:, g + lh - mh:g + lh,
                                                    cols])
            e[:, dn, cols].copy_(self.src(i + 1, j)[:, g:g + mh, cols])
        if not mhx:
            return
        for i, j in self.bufs:
            e = self.src(i, j)
            for rows in (up, dn):
                e[:, rows, :mhx].copy_(
                    self.src(i, j - 1)[:, rows, lw:lw + mhx])
                e[:, rows, mhx + lw:].copy_(
                    self.src(i, j + 1)[:, rows, mhx:2 * mhx])

    def exchange_bytes(self) -> int:
        """Bytes one exchange moves, all shards together."""
        p = self.bufs[0, 0][0].shape[0]
        mh, mhx = self.mh, self.mhx
        per = 2 * mhx * self.lh + 2 * mh * self.lw + 4 * mh * mhx
        return 4 * p * per * self.dy * self.dx

    def gather(self, device):
        """The ``(P, H, W)`` grid of the current shards on ``device``."""
        p = self.bufs[0, 0][0].shape[0]
        out = torch.empty((p, self.lh * self.dy, self.lw * self.dx),
                          dtype=self.bufs[0, 0][0].dtype, device=device)
        for i, j in self.bufs:
            out[:, i * self.lh:(i + 1) * self.lh,
                j * self.lw:(j + 1) * self.lw].copy_(
                self.center(self.src(i, j)))
        return out


class ShardedStreamKernel:
    """A generated stream kernel decomposed across a ``(dy, dx)`` mesh.

    Obtained via :meth:`repro_torch.core.codegen.StreamKernel.sharded`.
    The surface mirrors the single-device kernel — :meth:`run_blocked`,
    :meth:`run_for_point` and the declarative :meth:`multistep` — and
    ``d == 1`` delegates to the wrapped kernel. ``d`` is the total device
    count and ``dx`` its column factor (``dy = d / dx``). ``devices``:
    ``None`` takes ``cuda:0 … cuda:d-1`` (the CPU d times for a kernel on
    the CPU); a list may repeat a device. ``mesh`` is the resolved
    device list, ``(d,)`` for a ring and ``(dy, dx)`` nested otherwise.
    The state handed to a run must lie on the mesh's device type: a CUDA
    state on a CPU mesh (or the reverse) raises rather than moving the
    work.
    """

    def __init__(self, kernel, d: int, devices: Sequence | None = None,
                 dx: int = 1):
        self.kernel = kernel
        self.d = int(d)
        self.dy, self.dx = mesh_shape(self.d, dx)
        self.halo = kernel.halo
        self.halo_x = int(kernel.halo_x)
        if devices is None and kernel.device.type == "cpu":
            devices = [kernel.device] * self.d
        if self.d == 1:
            self.mesh = None
        elif self.dx == 1:
            self.mesh = ring_mesh(self.d, devices)
        else:
            self.mesh = device_mesh(self.dy, self.dx, devices)

    @property
    def grid(self) -> list:
        """The devices as ``dy`` rows of ``dx``."""
        if self.mesh is None:
            return [[self.kernel.device]]
        if self.dx == 1:
            return [[dev] for dev in self.mesh]
        return self.mesh

    def _guard_x(self, m: int) -> int:
        return m * self.halo_x if self.dx > 1 else 0

    def _check(self, state, steps: int, m: int, block_h: int) -> None:
        _check_state(state, len(self.kernel._ports))
        _, h, w = state.shape
        local_h = shard_height(h, self.dy)
        local_w = shard_width(w, self.dx)
        if m < 1:
            raise ValueError(f"m={m} must be >= 1")
        if local_h % block_h:
            raise ValueError(
                f"shard height {local_h} (h={h} over d={self.dy}) must be "
                f"divisible by block_h={block_h}"
            )
        if m * self.halo > block_h:
            raise ValueError(
                f"m*halo={m * self.halo} must be <= block_h={block_h} "
                "(halo source)"
            )
        if self.dx > 1 and m * self.halo_x > local_w:
            raise ValueError(
                f"m*halo_x={m * self.halo_x} must be <= the shard width "
                f"{local_w} (w={w} over dx={self.dx}; the column guard is "
                "sourced from one neighbor shard per side)"
            )
        if steps % m:
            raise ValueError(f"steps={steps} must be a multiple of m={m}")

    def shards(self, state, *, m: int, block_h: int) -> ShardBuffers:
        """``state`` cut into this mesh's guard-extended shard buffers for
        an ``(m, block_h)`` plan."""
        return ShardBuffers(state, self.grid, block_h=block_h,
                            mh=m * self.halo, mhx=self._guard_x(m))

    def _advance(self, sb: ShardBuffers, launch) -> None:
        """One fused launch of every shard: exchange, then ``launch(ext,
        out=...)`` per shard into the other buffer's center rows, then
        swap the buffers. Without y reach there are no guard rows, and
        the launch is the periodic one over the (column-extended)
        shard."""
        sb.exchange_x()
        sb.exchange_y()
        for i, j in sb.bufs:
            launch(sb.src(i, j), out=sb.dst(i, j)[:, sb.g:sb.g + sb.lh])
        sb.swap()

    # ---- launches (mirroring StreamKernel) ---------------------------------

    def _run(self, state, regs, *, steps: int, m: int, block_h: int,
             launch_fn, **launch_kw):
        """``steps // m`` fused launches of every shard through
        ``launch_fn``; the grid comes back on the mesh's first device."""
        mesh_dev = self.grid[0][0]
        if state.device.type != mesh_dev.type:
            n = len(self.grid) * len(self.grid[0])
            raise ValueError(
                f"state on {state.device} but mesh on {mesh_dev.type}; pass "
                f"devices=['{state.device}'] * {n}"
            )
        self._check(state, steps, m, block_h)
        scal = self.kernel._scal(regs)
        program = self.kernel.program

        def launch(ext, out):
            return launch_fn(program, ext, scal, m=m, block_h=block_h,
                             out=out, **launch_kw)

        sb = self.shards(state, m=m, block_h=block_h)
        for _ in range(steps // m):
            self._advance(sb, launch)
        return sb.gather(self.grid[0][0])

    def run_blocked(self, state, regs: Sequence = (), *, steps: int,
                    m: int, block_h: int, double_buffer: bool = True):
        """Advance ``steps`` time steps, exchanging halos every m steps,
        through the streamed halo launch; returns the ``(P, H, W)`` grid
        on the mesh's first device."""
        if self.d == 1:
            return self.kernel.run_blocked(
                state, regs, steps=steps, m=m, block_h=block_h,
                double_buffer=double_buffer,
            )
        from repro_torch.kernels.spd_stream.streaming import (
            spd_multistep_halo_streamed,
        )

        return self._run(state, regs, steps=steps, m=m, block_h=block_h,
                         launch_fn=spd_multistep_halo_streamed,
                         double_buffer=double_buffer)

    def multistep(self, state, regs: Sequence = (), *, m: int = 1,
                  block_h: int = 32):
        """One fused m-step advance of every shard through the declarative
        halo launch, the twin of :meth:`run_blocked` (bitwise equal)."""
        if self.d == 1:
            return self.kernel.multistep(state, regs, m=m, block_h=block_h)
        from repro_torch.kernels.spd_stream.sharded import spd_multistep_halo

        return self._run(state, regs, steps=m, m=m, block_h=block_h,
                         launch_fn=spd_multistep_halo)

    def run_for_point(self, state, regs: Sequence = (), *, point,
                      steps: int | None = None):
        """Advance the grid using a DSE design point's (block_h, m).

        The point is legalized *per shard* with the shared
        :func:`repro_torch.core.legalize.resolve_run_plan` (``d``/``dx`` =
        this mesh, the shard's width and guard columns priced), then the
        column tile is fitted at the shard's launch width ``W/dx +
        2·m·halo_x``, dropping to the single-buffer launch when no
        prefetching tile fits. Returns ``(result, (block_h, m,
        double_buffer))``.
        """
        _check_state(state, len(self.kernel._ports))
        p, h, w = state.shape
        block_h, m, nsteps, double_buffer = resolve_run_plan(
            h, point, steps, halo=self.halo, width=w, words=p, d=self.d,
            dx=self.dx, halo_x=self.halo_x,
        )
        width = shard_width(w, self.dx) + 2 * self._guard_x(m)
        block_w, double_buffer = self.kernel.tile(
            width, block_h, m, double_buffer=double_buffer)
        count_plan(self.kernel.program, shard_height(h, self.dy), width,
                   shard_width(w, self.dx), block_h, block_w, m, nsteps,
                   tiles=self.d)
        out = self.run_blocked(
            state, regs, steps=nsteps, m=m, block_h=block_h,
            double_buffer=double_buffer,
        )
        return out, (block_h, m, double_buffer)
