"""The logical device mesh (the port of the JAX package's
``launch/mesh.py``).

A :class:`Mesh` names its axes, gives their sizes and holds one device
per rank, row-major over the axes as ``jax.make_mesh`` lays them out. The
list may repeat a device: ``make_mesh((2, 4), ("data", "model"),
["cuda:0"] * 8)`` runs a (data 2, model 4) mesh on one card, and
``["cpu"] * 8`` runs it on the CPU, the counterpart of XLA's forced host
devices (docs/port.md §parallel). Building a mesh touches no device
state.
"""

from __future__ import annotations

import math

import torch

from repro_torch.interop import resolve_devices


class Mesh:
    """``axis_names``, ``axis_sizes`` and ``devices`` (one
    ``torch.device`` per rank, rank ``r`` at the row-major coordinates
    :meth:`coords` gives). ``shape`` maps each axis name to its size, as
    a JAX mesh's does."""

    def __init__(self, axis_sizes, axis_names, devices):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(axis_names)
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")
        self.devices = list(devices)
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh needs {self.size} "
                             f"devices, got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s coordinate on each axis (row-major)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            rank, out[name] = divmod(rank, size)
        return {name: out[name] for name in self.axis_names}

    def rank(self, coords: dict) -> int:
        """The rank at ``coords`` (every axis named)."""
        r = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            r = r * size + coords[name]
        return r

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices {devs})"


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. ``devices`` as
    ``interop.resolve_devices`` takes it: ``None`` for ``cuda:0`` …
    (raises without enough cards), or a list that may repeat a
    device."""
    n = math.prod(shape)
    return Mesh(shape, axes, resolve_devices(devices, n))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 ranks per pod; ``multi_pod`` adds a 2-pod leading
    axis. Without ``devices`` every rank is the ``meta`` device: a layout
    that sharding specs are resolved against and that allocates
    nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        return Mesh(shape, axes, [torch.device("meta")] * math.prod(shape))
    return make_mesh(shape, axes, devices)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def dp_axes_for(mesh, global_batch: int):
    """Data-parallel axes for a batch: ('pod','data') when both divide,
    'data' when only the single-pod width divides, else None (replicate —
    the long_500k batch=1 case)."""
    sizes = mesh_axis_sizes(mesh)
    if "pod" in sizes:
        full = sizes["pod"] * sizes["data"]
        if global_batch % full == 0:
            return ("pod", "data")
    if global_batch % sizes["data"] == 0:
        return ("data",)
    return None
