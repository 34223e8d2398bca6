"""The SPD HDL-node library, implemented over PyTorch streams.

The port of the JAX package's ``core/library.py``: the paper's library
modules (§II-D) — Synchronous multiplexer, Comparator, Eliminator, Delay,
Stream forward, Stream backward and the 2D stencil buffer — each as a
:class:`LibraryModule`: a torch dataflow implementation, a pipeline-delay /
resource oracle for the hardware model, and a **CUDA emitter** that prints
the module's device statements into a generated stream kernel
(docs/port.md §ir).

Stream convention: a stream variable is a tensor whose *leading* axes are
the stream coordinates. 1-D modules (Delay/Forward/Backward) shift along
axis 0 of a flat stream; ``Stencil2D`` treats the stream as a row-major 2-D
field ``(H, W)``. ``Stencil2D`` has no emitter: the stripe lowering turns
it into a zero-fill shared-memory read (``repro_torch.core.codegen``), and
the 1-D modules have no 2-D stripe lowering at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .dfg import Node, SPDError


class SPDModuleError(SPDError):
    pass


def f32_literal(v: float) -> str:
    """A C ``float`` literal of ``v`` at its f32 rounding (``2.5f``).

    ``str(np.float32(v))`` is the shortest decimal that reads back as the
    same f32, so the printed constant is exactly the reference's
    ``jnp.float32(v)``; the ``f`` suffix keeps the expression in single
    precision (a bare ``0.5`` would promote it to double).
    """
    x = np.float32(v)
    if not np.isfinite(x):
        raise SPDModuleError(f"constant {v!r} is not a finite f32")
    text = str(x)
    if "e" not in text and "." not in text:
        text += ".0"
    return f"({text}f)" if x < 0 else f"{text}f"


def _shift0(x, k: int, fill=0.0):
    """out[t] = x[t-k] (k>0: delay; k<0: forward), zero fill."""
    if k == 0:
        return x
    pad = torch.full((abs(k),) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    if k > 0:
        return torch.cat([pad, x[:-k]], dim=0)
    return torch.cat([x[-k:], pad], dim=0)


def _shift2d(x, dy: int, dx: int, mode: str):
    """out[y, x] = in[y-dy, x-dx]; mode in {'wrap', 'zero'}."""
    if mode == "wrap":
        out = x
        if dy:
            out = torch.roll(out, dy, dims=0)
        if dx:
            out = torch.roll(out, dx, dims=1)
        return out
    if mode != "zero":
        raise SPDModuleError(f"Stencil2D: unknown boundary mode {mode!r}")
    out = x
    if dy:
        pad = torch.zeros((abs(dy),) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out = (
            torch.cat([pad, out[:-dy]], dim=0)
            if dy > 0
            else torch.cat([out[-dy:], pad], dim=0)
        )
    if dx:
        pad = torch.zeros((out.shape[0], abs(dx)) + tuple(out.shape[2:]),
                          dtype=x.dtype, device=x.device)
        out = (
            torch.cat([pad, out[:, :-dx]], dim=1)
            if dx > 0
            else torch.cat([out[:, -dx:], pad], dim=1)
        )
    return out


#: ``cuda(outs, ins, params) -> [C statements]``: ``outs`` are the C names
#: to declare, ``ins`` C expressions of the inputs (per-cell variables,
#: register reads or f32 literals).
CudaEmitter = Callable[[Sequence[str], Sequence[str], Mapping], list]


@dataclass
class LibraryModule:
    """A leaf HDL module: torch impl + hardware-model oracles + CUDA emitter."""

    name: str
    n_in: int
    n_out: int
    param_names: tuple[str, ...]
    impl: Callable[[Sequence, Mapping], list]
    delay_fn: Callable[[Mapping], int]
    census_fn: Callable[[Mapping], dict] = lambda p: {}
    # Estimated on-chip buffer bits consumed (BRAM analogue), for the DSE.
    buffer_bits_fn: Callable[[Mapping], int] = lambda p: 0
    # Prints the module's device statements (None: no stream-kernel lowering).
    cuda: CudaEmitter | None = None

    def resolve_params(self, node: Node, core_params: Mapping[str, float]) -> dict:
        """Bind an HDL node's positional/named params against this module."""
        out: dict = {}
        pos = 0
        for raw in node.params:
            if "=" in raw:
                k, v = raw.split("=", 1)
                out[k.strip()] = _coerce(v.strip(), core_params)
            else:
                if pos >= len(self.param_names):
                    raise SPDModuleError(
                        f"{self.name}: too many params on node {node.name}"
                    )
                out[self.param_names[pos]] = _coerce(raw.strip(), core_params)
                pos += 1
        return out

    def apply(self, inputs: Sequence, params: Mapping) -> list:
        if self.n_in >= 0 and len(inputs) != self.n_in:
            raise SPDModuleError(
                f"{self.name}: expected {self.n_in} inputs, got {len(inputs)}"
            )
        outs = self.impl(inputs, params)
        if self.n_out >= 0 and len(outs) != self.n_out:
            raise SPDModuleError(
                f"{self.name}: produced {len(outs)} outputs, expected {self.n_out}"
            )
        return outs


def _coerce(v: str, core_params: Mapping[str, float]):
    if v in core_params:
        return core_params[v]
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except ValueError:
        return v  # string param (e.g. boundary mode, comparator op)


# --------------------------------------------------------------------------
# Module implementations
# --------------------------------------------------------------------------


def _delay_impl(ins, p):
    return [_shift0(ins[0], int(p.get("k", 1)))]


def _forward_impl(ins, p):
    return [_shift0(ins[0], -int(p.get("k", 1)))]


def _mux_impl(ins, p):
    sel, a, b = ins
    return [torch.where(sel != 0, a, b)]


def _mux_cuda(outs, ins, p):
    sel, a, b = ins
    return [f"const float {outs[0]} = ({sel} != 0.0f) ? {a} : {b};"]


_CMP_OPS = {
    "eq": (lambda a, b: a == b, "=="),
    "ne": (lambda a, b: a != b, "!="),
    "lt": (lambda a, b: a < b, "<"),
    "le": (lambda a, b: a <= b, "<="),
    "gt": (lambda a, b: a > b, ">"),
    "ge": (lambda a, b: a >= b, ">="),
}


def _cmp_op(p):
    op = p.get("op", "eq")
    if op not in _CMP_OPS:
        raise SPDModuleError(f"Comparator: unknown op {op!r}")
    return _CMP_OPS[op]


def _cmp_impl(ins, p):
    fn, _ = _cmp_op(p)
    a, b = ins
    return [fn(a, b).to(torch.float32)]


def _cmp_cuda(outs, ins, p):
    _, c_op = _cmp_op(p)
    a, b = ins
    return [f"const float {outs[0]} = ({a} {c_op} {b}) ? 1.0f : 0.0f;"]


def _eliminator_impl(ins, p):
    # Hardware semantics: drop elements with enable==0 (stream compaction).
    # Fixed-shape dataflow semantics: mask to zero; host-side compaction is
    # provided by repro_torch.core.transforms.compact_stream.
    en, x = ins
    return [torch.where(en != 0, x, torch.zeros_like(x))]


def _eliminator_cuda(outs, ins, p):
    en, x = ins
    return [f"const float {outs[0]} = ({en} != 0.0f) ? {x} : 0.0f;"]


def _stencil2d_impl(ins, p):
    dy, dx = int(p.get("dy", 0)), int(p.get("dx", 0))
    return [_shift2d(ins[0], dy, dx, str(p.get("mode", "zero")))]


def _stencil2d_delay(p) -> int:
    # The buffer must see max(dy,0) future rows + max(dx,0) future columns
    # before the aligned element can leave; +2 for ingress/egress registers.
    w = int(p.get("W", 0))
    dy, dx = int(p.get("dy", 0)), int(p.get("dx", 0))
    return max(-dy, 0) * max(w, 1) + max(-dx, 0) + 2


def _stencil2d_bits(p) -> int:
    w = int(p.get("W", 0))
    dy = abs(int(p.get("dy", 0)))
    return 32 * (dy * max(w, 1) + abs(int(p.get("dx", 0))) + 2)


def default_registry_modules() -> list[LibraryModule]:
    return [
        LibraryModule(
            "Delay", 1, 1, ("k",), _delay_impl,
            delay_fn=lambda p: int(p.get("k", 1)),
            buffer_bits_fn=lambda p: 32 * int(p.get("k", 1)),
        ),
        LibraryModule(
            "StreamForward", 1, 1, ("k",), _forward_impl,
            # Forward reference: everything else is delayed by k to meet it.
            delay_fn=lambda p: int(p.get("k", 1)),
            buffer_bits_fn=lambda p: 32 * int(p.get("k", 1)),
        ),
        LibraryModule(
            "StreamBackward", 1, 1, ("k",), _delay_impl,
            delay_fn=lambda p: int(p.get("k", 1)),
            buffer_bits_fn=lambda p: 32 * int(p.get("k", 1)),
        ),
        LibraryModule(
            "SyncMux", 3, 1, (), _mux_impl, delay_fn=lambda p: 2,
            cuda=_mux_cuda,
        ),
        LibraryModule(
            "Comparator", 2, 1, ("op",), _cmp_impl, delay_fn=lambda p: 2,
            cuda=_cmp_cuda,
        ),
        LibraryModule(
            "Eliminator", 2, 1, (), _eliminator_impl, delay_fn=lambda p: 2,
            cuda=_eliminator_cuda,
        ),
        LibraryModule(
            "Stencil2D", 1, 1, ("dy", "dx", "W", "mode"), _stencil2d_impl,
            delay_fn=_stencil2d_delay,
            buffer_bits_fn=_stencil2d_bits,
        ),
    ]
