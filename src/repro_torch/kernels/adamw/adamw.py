"""Hand-written fused AdamW pass (``csrc/adamw.cu``).

Replaces no TPU kernel: the JAX package's AdamW (``train/optimizer.py``)
is plain ``jnp``, which XLA fuses. The port's plain version is
:mod:`repro_torch.train.optimizer`'s ``_global_norm`` and ``_update``, one
torch kernel and one f32 temporary for each op; on CUDA parameters
:func:`~repro_torch.train.optimizer.apply_updates` runs this pair instead:

* :func:`adamw_sumsq` — the gradients' global norm and the clip scale,
  into a device buffer, in a fixed summation order (a run repeats bit for
  bit; the order differs from plain's, so the norm agrees to rounding);
* :func:`adamw_step` — ``_update`` on every part in one pass, op for op,
  so ``p``, ``m`` and ``v`` come out bitwise plain's for the same scale.

Bound on the card: bytes, each state word read and written once (22
bytes a parameter with bf16 ``p`` and ``g`` and f32 moments, 2 more for
the norm). The parts travel as tables of :data:`MAX_PARTS` in the
kernel's parameters (:func:`pack`), one launch a table.

A part is an :class:`AdamWPart`: one contiguous tensor of the parameter
tree (a parameter, or one layer of an ``interop.Stacked`` leaf) with its
gradient and moments. The kernel takes f32 or bf16 parameters, f32 or
bf16 gradients and f32 or bf16 moments (``m`` and ``v`` of one dtype), in
any combination, and raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: Elements a tile of the kernels' walk (``ADAMW_TILE``).
TILE = 2048
#: Parts in one table, one launch (``ADAMW_MAX_PARTS``).
MAX_PARTS = 48
#: Partial sums ``adamw_sumsq`` writes a table (``ADAMW_SUMSQ_BLOCKS``).
SUMSQ_BLOCKS = 1024
#: Bits of a table entry's ``codes`` (``ADAMW_P_BF16`` …).
P_BF16, G_BF16, S_BF16, DECAY, ALIGNED = 1, 2, 4, 8, 16

DTYPES = (torch.float32, torch.bfloat16)


class AdamWPart(NamedTuple):
    """One tensor of the update: ``name`` for errors, the parameter
    ``p``, its gradient ``g``, its moments ``m`` and ``v`` (all of one
    shape), and whether it decays."""

    name: str
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    decay: bool


def _codes(part: AdamWPart) -> int:
    """The part's bits, after the checks the kernel needs."""
    for role in ("p", "g", "m", "v"):
        x = getattr(part, role)
        if x.dtype not in DTYPES:
            raise TypeError(f"{part.name}: {role} is {x.dtype}; the AdamW "
                            f"kernel takes {DTYPES}")
        if x.shape != part.p.shape:
            raise ValueError(f"{part.name}: {role} has shape "
                             f"{tuple(x.shape)}, p {tuple(part.p.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{part.name}: {role} is not contiguous")
    if part.m.dtype != part.v.dtype:
        raise TypeError(f"{part.name}: m is {part.m.dtype}, v "
                        f"{part.v.dtype}; the kernel takes one moment dtype")
    aligned = all(x.data_ptr() % 16 == 0
                  for x in (part.p, part.g, part.m, part.v))
    bf16 = torch.bfloat16
    return ((P_BF16 if part.p.dtype == bf16 else 0)
            | (G_BF16 if part.g.dtype == bf16 else 0)
            | (S_BF16 if part.m.dtype == bf16 else 0)
            | (DECAY if part.decay else 0)
            | (ALIGNED if aligned else 0))


class Part(ctypes.Structure):
    """``struct AdamwPart`` of ``csrc/adamw.cu``: one part's pointers, its
    elements, its tiles ``[tile0, tile_end)`` of the table's walk and its
    :data:`P_BF16` … bits."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("numel", ctypes.c_longlong), ("tile0", ctypes.c_longlong),
                ("tile_end", ctypes.c_longlong), ("codes", ctypes.c_int),
                ("pad", ctypes.c_int)]


class Table(ctypes.Structure):
    """``struct AdamwTable`` of ``csrc/adamw.cu``: its first ``n`` parts,
    ``tiles`` in all; passed by address, the C side copies it into the
    launch's parameters."""

    _fields_ = [("part", Part * MAX_PARTS), ("n", ctypes.c_int),
                ("pad", ctypes.c_int), ("tiles", ctypes.c_longlong)]


def pack(parts) -> list[Table]:
    """The tables of ``parts`` in order, at most :data:`MAX_PARTS` a
    table, each part's tiles numbered from its table's start; empty parts
    are left out. Raises on a part the kernel does not take (a dtype, a
    shape, a layout), naming it."""
    tables = []
    for part in parts:
        codes = _codes(part)
        n = part.p.numel()
        if n == 0:
            continue
        if not tables or tables[-1].n == MAX_PARTS:
            tables.append(Table())
        t = tables[-1]
        end = t.tiles + -(-n // TILE)
        t.part[t.n] = Part(part.p.data_ptr(), part.g.data_ptr(),
                           part.m.data_ptr(), part.v.data_ptr(), n, t.tiles,
                           end, codes, 0)
        t.n, t.tiles = t.n + 1, end
    return tables


@functools.cache
def _library():
    """The built library, its layout checked against this module's."""
    lib = build.load_adamw_library()
    theirs = (lib.adamw_tile(), lib.adamw_max_parts(),
              lib.adamw_sumsq_blocks(), lib.adamw_table_bytes())
    ours = (TILE, MAX_PARTS, SUMSQ_BLOCKS, ctypes.sizeof(Table))
    if theirs != ours:
        raise RuntimeError(f"csrc/adamw.cu's layout {theirs} is not the "
                           f"wrapper's {ours}")
    return lib


def _device(parts) -> torch.device:
    """The one CUDA device of every tensor of ``parts``."""
    if not parts:
        raise ValueError("the AdamW kernel needs at least one part")
    dev = parts[0].p.device
    if dev.type != "cuda":
        raise RuntimeError(f"the AdamW kernel takes CUDA tensors, got {dev} "
                           "(apply_updates runs the plain version there)")
    for part in parts:
        for x in (part.p, part.g, part.m, part.v):
            if x.device != dev:
                raise ValueError(f"{part.name}: a tensor on {x.device}, the "
                                 f"first part's on {dev}")
    return dev


def _scalar(x: torch.Tensor, what: str, dev) -> torch.Tensor:
    if (not isinstance(x, torch.Tensor) or x.numel() != 1
            or x.dtype != torch.float32 or x.device != dev):
        raise TypeError(f"{what} must be one float32 element on {dev}")
    return x


def adamw_sumsq(parts, clip_norm: float) -> torch.Tensor:
    """``(2,)`` float32 on the parts' device: the gradients' global norm
    ``sqrt(sum g²)`` and the clip scale ``min(clip_norm / max(norm,
    1e-9), 1)``, computed on the card with no wait of the host."""
    dev = _device(parts)
    tables = pack(parts)
    lib = _library()
    partial = torch.empty(len(tables) * SUMSQ_BLOCKS, dtype=torch.float32,
                          device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, table in enumerate(tables):
            build.check(lib.adamw_sumsq(
                ctypes.addressof(table),
                partial.data_ptr() + 4 * i * SUMSQ_BLOCKS, stream,
            ), "adamw_sumsq")
            adamw_sumsq.launches += 1
        build.check(lib.adamw_finalize(
            partial.data_ptr(), partial.numel(), float(clip_norm),
            out.data_ptr(), stream,
        ), "adamw_finalize")
        adamw_sumsq.launches += 1
    return out


adamw_sumsq.launches = 0


def adamw_step(parts, lr, scale, bc1, bc2, *, b1: float, b2: float,
               eps: float, weight_decay: float) -> None:
    """``_update`` of every part in place: ``lr``, ``scale`` and the bias
    corrections ``bc1``, ``bc2`` are one-element float32 tensors on the
    parts' device; the Python scalars are rounded to float32 as PyTorch
    rounds them (``1 - b1`` and ``1 - b2`` taken in double first)."""
    dev = _device(parts)
    scalars = [_scalar(x, w, dev) for x, w in
               ((lr, "lr"), (scale, "scale"), (bc1, "bc1"), (bc2, "bc2"))]
    tables = pack(parts)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for table in tables:
            build.check(lib.adamw_step(
                ctypes.addressof(table), *(x.data_ptr() for x in scalars),
                b1, 1 - b1, b2, 1 - b2, eps, weight_decay, dev.index, stream,
            ), "adamw_step")
            adamw_step.launches += 1


adamw_step.launches = 0
