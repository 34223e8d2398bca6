"""SPD core -> PyTorch stream function compiler.

The port of the JAX package's ``core/compiler.py``. Where the paper's
compiler emits a pipelined Verilog datapath, this one emits a torch
dataflow function: EQU nodes become tensor expression trees, HDL nodes
become library-module or (recursively) sub-core calls, and DRCT lines
become wiring. The pipeline *timing* side (delay balancing, depth) is
computed by ``repro_torch.core.dfg.schedule`` and retained as the hardware
performance model (docs/pipeline.md §compile); its census, depth, balance
registers, buffer bits and halo equal the JAX package's exactly. One level
further down, ``repro_torch.core.codegen`` lowers the same core to a
generated Hopper stream kernel (docs/port.md §ir).

Constants and parameters are 0-d f32 tensors, so every scalar operation
rounds to f32 exactly as the reference's ``jnp.float32`` scalars do.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Mapping, Sequence

import numpy as np
import torch

from ..tracing import timed
from .dfg import (
    Bin,
    Call,
    Core,
    Expr,
    Neg,
    Node,
    Num,
    SPDError,
    Schedule,
    Var,
    flop_count,
    op_census,
    schedule,
)
from .library import LibraryModule, default_registry_modules


class SPDCompileError(SPDError):
    pass


def f32(v, device=None) -> torch.Tensor:
    """A 0-d f32 tensor of ``v`` (the port's ``jnp.float32(v)``)."""
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Module registry
# --------------------------------------------------------------------------


class Registry:
    """Resolves HDL module names to library modules or compiled sub-cores."""

    def __init__(self, include_default_library: bool = True):
        self._lib: dict[str, LibraryModule] = {}
        self._cores: dict[str, "CompiledCore"] = {}
        if include_default_library:
            for m in default_registry_modules():
                self.register_library(m)

    def register_library(self, mod: LibraryModule) -> None:
        self._lib[mod.name] = mod

    def register_core(self, compiled: "CompiledCore") -> None:
        self._cores[compiled.core.name] = compiled

    def lookup(self, name: str):
        if name in self._cores:
            return self._cores[name]
        if name in self._lib:
            return self._lib[name]
        raise SPDCompileError(f"unknown HDL module {name!r}")

    @timed("setup.compile")
    def compile(self, core: Core) -> "CompiledCore":
        compiled = CompiledCore(core, self)
        self.register_core(compiled)
        return compiled


# --------------------------------------------------------------------------
# EQU evaluation
# --------------------------------------------------------------------------

_CALL_IMPL = {
    "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "abs": torch.abs,
    "exp": torch.exp,
    "min": torch.minimum,
    "max": torch.maximum,
}


def eval_expr(e: Expr, env: Mapping[str, torch.Tensor], device=None):
    """Evaluate a formula in the reference's association order.

    ``device`` places the f32 literals; 0-d tensors combine with any
    operand, so the default (CPU) only matters for all-literal formulae.
    """
    if isinstance(e, Num):
        return f32(e.value, device)
    if isinstance(e, Var):
        try:
            return env[e.name]
        except KeyError:
            raise SPDCompileError(f"unbound variable {e.name!r}") from None
    if isinstance(e, Neg):
        return -eval_expr(e.arg, env, device)
    if isinstance(e, Bin):
        a, b = eval_expr(e.lhs, env, device), eval_expr(e.rhs, env, device)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        return a / b
    if isinstance(e, Call):
        args = [eval_expr(a, env, device) for a in e.args]
        return _CALL_IMPL[e.fn](*args)
    raise TypeError(f"unknown expr {e!r}")


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return f32(x, device)


def _device_of(values) -> torch.device | None:
    for v in values:
        if isinstance(v, torch.Tensor) and v.dim():
            return v.device
    return None


# --------------------------------------------------------------------------
# Compiled core
# --------------------------------------------------------------------------


@dataclass
class HardwareReport:
    """The DSE-facing summary of one core's synthesized shape.

    Field for field the JAX package's ``HardwareReport``.
    """

    name: str
    depth: int  # pipeline depth d (cycles)
    census: dict  # FP operator counts
    flops: int  # N_Flops: FP ops performed per streamed element
    balance_regs: int  # delay-balancing registers inserted (word-cycles)
    buffer_bits: int  # stencil/delay buffer bits (BRAM analogue)
    stream_in_words: int  # main-input words per element (bandwidth model)
    stream_out_words: int
    # Per-step stencil reach in rows (codegen inference).
    halo: int = 1

    def workload(self, elems: int, grid_w: int = 0):
        """Bind this report to a stream length -> DSE ``StreamWorkload``.

        The compile-to-explore hand-off: everything the sweep engine needs
        (flops, stream widths, depth, buffer bits) comes from the
        synthesized core; only the problem size is supplied here.
        """
        from .dse import StreamWorkload

        return StreamWorkload.from_report(self, elems=elems, grid_w=grid_w)


class CompiledCore:
    """An SPD core compiled to a callable torch dataflow function."""

    def __init__(self, core: Core, registry: Registry):
        self.core = core
        self.registry = registry
        core.toposort()  # validate graph at compile time

    # ---- hardware model ----------------------------------------------------

    def _node_params(self, node: Node) -> dict:
        mod = self.registry.lookup(node.module)
        if isinstance(mod, LibraryModule):
            return mod.resolve_params(node, self.core.params)
        return {}

    def _hdl_delay(self, node: Node) -> int:
        mod = self.registry.lookup(node.module)
        if isinstance(mod, LibraryModule):
            return mod.delay_fn(self._node_params(node))
        # Sub-core: the declared delay (paper semantics: statically known).
        # Fall back to the sub-core's scheduled depth when undeclared.
        if node.delay is not None and node.delay > 0:
            return node.delay
        return mod.schedule.depth

    def _hdl_census(self, node: Node) -> dict:
        mod = self.registry.lookup(node.module)
        if isinstance(mod, LibraryModule):
            return mod.census_fn(self._node_params(node))
        return mod.census

    @cached_property
    def schedule(self) -> Schedule:
        return schedule(self.core, self._hdl_delay)

    @cached_property
    def census(self) -> dict:
        return op_census(self.core, self._hdl_census)

    @cached_property
    def flops(self) -> int:
        return flop_count(self.census)

    @cached_property
    def buffer_bits(self) -> int:
        total = self.schedule.balance_regs * 32
        for n in self.core.nodes:
            if n.kind != "hdl":
                continue
            mod = self.registry.lookup(n.module)
            if isinstance(mod, LibraryModule):
                total += mod.buffer_bits_fn(self._node_params(n))
            else:
                total += mod.buffer_bits
        return total

    @cached_property
    def stream_halo(self) -> int:
        """Per-step stencil reach in rows, from the codegen's DFG inference.

        Cores the stream codegen cannot analyze (1-D stream state and
        other docs/pipeline.md §codegen rejections) fall back to 1 — the
        LBM-like default — as in the reference.
        """
        from .codegen import stencil_summary

        try:
            return stencil_summary(self).halo_y
        except SPDError:
            return 1

    @cached_property
    def hardware_report(self) -> HardwareReport:
        s = self.schedule
        return HardwareReport(
            name=self.core.name,
            depth=s.depth,
            census=dict(self.census),
            flops=self.flops,
            balance_regs=s.balance_regs,
            buffer_bits=self.buffer_bits,
            stream_in_words=len(self.core.main_input_ports()),
            stream_out_words=len(self.core.main_output_ports()),
            halo=self.stream_halo,
        )

    def stream_workload(self, elems: int, grid_w: int = 0):
        """``hardware_report.workload(...)`` with the Hopper tile of this
        core's generated kernel (its resident planes, guard rows, blocks
        per SM and register owners, for the GPU model's ``smem`` rule and
        its launch tile, docs/port.md §dse); a core the stream codegen
        cannot lower keeps the unknown-tile default."""
        from dataclasses import replace

        from .codegen import lower_stripe, stencil_summary

        w = self.hardware_report.workload(elems, grid_w)
        try:
            summary = stencil_summary(self)
            prog = lower_stripe(self, summary.halo(), summary.halo_x)
        except SPDError:
            return w
        return replace(
            w,
            tile_planes=prog.launch_planes(streamed=True,
                                           double_buffer=False),
            tile_guard_rows=prog.guard_rows,
            tile_planes_prefetch=prog.launch_planes(streamed=True,
                                                    double_buffer=True),
            tile_blocks_per_sm=prog.blocks_per_sm,
            tile_owner_cells=prog.owner_cells,
        )

    def explorer(self, elems: int, grid_w: int = 0, **kw):
        """Design-space :class:`~repro_torch.core.explorer.Explorer` of
        this core. The explorer keeps a reference to the core, so GPU
        lattice points can be *executed* through the generated stream
        kernel (``Explorer.search``, docs/pipeline.md §execute)."""
        from .explorer import Explorer

        kw.setdefault("core", self)
        kw.setdefault("census", self.hardware_report.census)
        return Explorer(self.stream_workload(elems, grid_w), **kw)

    def stream_kernel(self, device="cuda"):
        """Lower this core to a generated Hopper stream kernel.

        Raises :class:`~repro_torch.core.codegen.CodegenError` for cores
        the stream target cannot express (branch streams, 1-D stream
        state, non-periodic stencils, modules without a CUDA emitter),
        and ``RuntimeError`` for ``device="cuda"`` without a card.
        """
        from .codegen import StreamKernel

        return StreamKernel(self, device=device)

    # ---- execution -----------------------------------------------------------

    def apply(self, inputs: Sequence) -> list:
        """Positional call: inputs ordered main_in + brch_in + regs,
        outputs ordered main_out + brch_out (matches SPD module-call syntax).
        """
        names = self.core.input_ports()
        if len(inputs) != len(names):
            raise SPDCompileError(
                f"core {self.core.name}: expected {len(names)} inputs "
                f"({names}), got {len(inputs)}"
            )
        device = _device_of(inputs)
        env: dict = dict(zip(names, inputs))
        env.update({k: f32(v, device) for k, v in self.core.params.items()})
        alias = self.core.alias_map()

        for node in self.core.toposort():
            ins = [env[alias.get(v, v)] for v in node.inputs]
            if node.kind == "equ":
                local = dict(env)
                local.update({
                    v: _as_f32(env[alias.get(v, v)], device)
                    for v in node.inputs
                })
                env[node.outputs[0]] = eval_expr(node.expr, local, device)
            else:
                mod = self.registry.lookup(node.module)
                if isinstance(mod, LibraryModule):
                    ins = [_as_f32(x, device) for x in ins]
                    outs = mod.apply(ins, mod.resolve_params(node, self.core.params))
                else:
                    outs = mod.apply(ins)
                if len(outs) != len(node.outputs):
                    raise SPDCompileError(
                        f"node {node.name}: module {node.module} returned "
                        f"{len(outs)} outputs, node declares {len(node.outputs)}"
                    )
                for name, val in zip(node.outputs, outs):
                    env[name] = val

        outs = []
        for p in self.core.output_ports():
            src = alias.get(p, p)
            if src not in env:
                raise SPDCompileError(
                    f"core {self.core.name}: output port {p!r} undriven"
                )
            outs.append(env[src])
        return outs

    def __call__(self, main_in: Mapping, brch_in: Mapping | None = None,
                 regs: Mapping | None = None):
        """Named call returning ``(main_out: dict, brch_out: dict)``."""
        brch_in = brch_in or {}
        regs = regs or {}
        args = []
        for p in self.core.main_input_ports():
            args.append(main_in[p])
        for p in self.core.brch_input_ports():
            args.append(brch_in[p])
        for p in self.core.regs:
            args.append(regs[p])
        outs = self.apply(args)
        mo = self.core.main_output_ports()
        main_out = dict(zip(mo, outs[: len(mo)]))
        brch_out = dict(zip(self.core.brch_output_ports(), outs[len(mo):]))
        return main_out, brch_out
