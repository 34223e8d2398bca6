"""Data-flow graph IR for SPD cores (a verbatim copy of the JAX package's
``core/dfg.py``, which imports no framework; ``tests/test_torch_frontend.py``
holds the two to the same structures).

This module holds the hardware-facing side of the SPD compiler: the expression
AST for ``EQU`` formulae, the node/core IR produced by the parser, ASAP
pipeline scheduling with delay balancing (the paper's Fig. 3b step), pipeline
depth computation, and the floating-point-operator census that feeds the
design-space-exploration cost model (``N_Flops`` in the paper's Eq. 10).

The *semantic* compilation of a core to a PyTorch function lives in
``repro_torch.core.compiler``; here we only reason about structure and timing
(stage two of the pipeline, docs/pipeline.md §dfg).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping, Sequence

# --------------------------------------------------------------------------
# Expression AST for EQU formulae
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Num(Expr):
    value: float


@dataclass(frozen=True)
class Var(Expr):
    name: str


@dataclass(frozen=True)
class Bin(Expr):
    op: str  # '+', '-', '*', '/'
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Neg(Expr):
    arg: Expr


@dataclass(frozen=True)
class Call(Expr):
    fn: str  # 'sqrt' (extensible: 'abs', 'min', 'max', 'rsqrt', 'exp')
    args: tuple[Expr, ...]


SUPPORTED_CALLS = ("sqrt", "abs", "min", "max", "rsqrt", "exp")


def expr_vars(e: Expr) -> list[str]:
    """Free variables of an expression, in first-appearance order."""
    out: list[str] = []

    def walk(x: Expr) -> None:
        if isinstance(x, Var):
            if x.name not in out:
                out.append(x.name)
        elif isinstance(x, Bin):
            walk(x.lhs)
            walk(x.rhs)
        elif isinstance(x, Neg):
            walk(x.arg)
        elif isinstance(x, Call):
            for a in x.args:
                walk(a)

    walk(e)
    return out


def expr_op_census(e: Expr) -> dict[str, int]:
    """Count FP operators in a formula (the paper's Table IV census)."""
    census: dict[str, int] = {}

    def bump(k: str) -> None:
        census[k] = census.get(k, 0) + 1

    def walk(x: Expr) -> None:
        if isinstance(x, Bin):
            # '+' and '-' both map onto an FP adder.
            bump("add" if x.op in "+-" else ("mul" if x.op == "*" else "div"))
            walk(x.lhs)
            walk(x.rhs)
        elif isinstance(x, Neg):
            walk(x.arg)  # negation is a sign flip, not a pipelined FP op
        elif isinstance(x, Call):
            bump(x.fn)
            for a in x.args:
                walk(a)

    walk(e)
    return census


# Pipelined-operator latency model (cycles). Calibrated loosely against the
# Stratix V single-precision cores the paper used; fully overridable so other
# device models can be swapped in for the DSE.
DEFAULT_OP_LATENCY: dict[str, int] = {
    "add": 7,
    "mul": 5,
    "div": 28,
    "sqrt": 28,
    "rsqrt": 28,
    "abs": 1,
    "min": 2,
    "max": 2,
    "exp": 17,
}


def expr_depth(e: Expr, latency: Mapping[str, int] | None = None) -> int:
    """Critical-path latency (cycles) through a formula's operator tree."""
    lat = dict(DEFAULT_OP_LATENCY)
    if latency:
        lat.update(latency)

    def walk(x: Expr) -> int:
        if isinstance(x, (Num, Var)):
            return 0
        if isinstance(x, Bin):
            op = "add" if x.op in "+-" else ("mul" if x.op == "*" else "div")
            return lat[op] + max(walk(x.lhs), walk(x.rhs))
        if isinstance(x, Neg):
            return walk(x.arg)
        if isinstance(x, Call):
            inner = max((walk(a) for a in x.args), default=0)
            return lat[x.fn] + inner
        raise TypeError(f"unknown expr {x!r}")

    return walk(e)


# --------------------------------------------------------------------------
# Node / Core IR
# --------------------------------------------------------------------------


@dataclass
class Node:
    """One DFG node: an EQU formula or an HDL module call."""

    name: str
    kind: str  # 'equ' | 'hdl'
    inputs: tuple[str, ...]  # variable names consumed (positional for hdl)
    outputs: tuple[str, ...]  # variable names produced
    expr: Expr | None = None  # equ only
    module: str | None = None  # hdl only: module name
    delay: int | None = None  # hdl only: declared pipeline delay
    params: tuple[str, ...] = ()  # hdl only: raw parameter list


@dataclass
class Interface:
    name: str
    ports: tuple[str, ...]


@dataclass
class Core:
    """A parsed SPD core: interfaces + nodes + direct connections."""

    name: str
    main_in: list[Interface] = field(default_factory=list)
    main_out: list[Interface] = field(default_factory=list)
    brch_in: list[Interface] = field(default_factory=list)
    brch_out: list[Interface] = field(default_factory=list)
    regs: list[str] = field(default_factory=list)  # Append_Reg constant inputs
    params: dict[str, float] = field(default_factory=dict)
    nodes: list[Node] = field(default_factory=list)
    # DRCT lines: (dest ports) = (src ports), applied pairwise.
    drcts: list[tuple[tuple[str, ...], tuple[str, ...]]] = field(default_factory=list)

    # ---- interface helpers -------------------------------------------------
    def input_ports(self) -> list[str]:
        out = [p for itf in self.main_in for p in itf.ports]
        out += [p for itf in self.brch_in for p in itf.ports]
        out += list(self.regs)
        return out

    def main_input_ports(self) -> list[str]:
        return [p for itf in self.main_in for p in itf.ports]

    def main_output_ports(self) -> list[str]:
        return [p for itf in self.main_out for p in itf.ports]

    def brch_input_ports(self) -> list[str]:
        return [p for itf in self.brch_in for p in itf.ports]

    def brch_output_ports(self) -> list[str]:
        return [p for itf in self.brch_out for p in itf.ports]

    def output_ports(self) -> list[str]:
        return self.main_output_ports() + self.brch_output_ports()

    # ---- graph helpers -----------------------------------------------------
    def producers(self) -> dict[str, Node]:
        """variable name -> producing node (SSA check)."""
        prod: dict[str, Node] = {}
        for n in self.nodes:
            for v in n.outputs:
                if v in prod:
                    raise SPDGraphError(
                        f"core {self.name}: variable '{v}' assigned by both "
                        f"'{prod[v].name}' and '{n.name}' (must be SSA)"
                    )
                prod[v] = n
        return prod

    def alias_map(self) -> dict[str, str]:
        """DRCT wiring: destination variable -> source variable (resolved)."""
        alias: dict[str, str] = {}
        for dests, srcs in self.drcts:
            if len(dests) != len(srcs):
                raise SPDGraphError(
                    f"core {self.name}: DRCT arity mismatch {dests} = {srcs}"
                )
            for d, s in zip(dests, srcs):
                if d in alias:
                    raise SPDGraphError(f"core {self.name}: '{d}' DRCT-driven twice")
                alias[d] = s
        # Resolve chains (a<-b, b<-c => a<-c); reject cycles.
        resolved: dict[str, str] = {}
        for d in alias:
            seen = {d}
            s = alias[d]
            while s in alias:
                if s in seen:
                    raise SPDGraphError(f"core {self.name}: DRCT cycle at '{s}'")
                seen.add(s)
                s = alias[s]
            resolved[d] = s
        return resolved

    def toposort(self) -> list[Node]:
        """Topological order of nodes; raises on combinational cycles."""
        prod = self.producers()
        alias = self.alias_map()
        avail = set(self.input_ports())
        avail.update(self.params)  # params act as constants
        order: list[Node] = []
        pending = list(self.nodes)
        while pending:
            progressed = False
            for n in list(pending):
                deps = [alias.get(v, v) for v in n.inputs]
                if all(d in avail or d not in prod or prod[d] in order for d in deps):
                    # a dep is satisfied if it is a core input, a parameter, or
                    # produced by an already-ordered node
                    ok = True
                    for d in deps:
                        if d in avail:
                            continue
                        if d in prod:
                            if prod[d] not in order:
                                ok = False
                                break
                        else:
                            raise SPDGraphError(
                                f"core {self.name}: node '{n.name}' reads "
                                f"undriven variable '{d}'"
                            )
                    if not ok:
                        continue
                    order.append(n)
                    pending.remove(n)
                    avail.update(n.outputs)
                    progressed = True
            if not progressed:
                names = [n.name for n in pending]
                raise SPDGraphError(
                    f"core {self.name}: combinational cycle among {names}"
                )
        return order


class SPDError(Exception):
    """Base class for SPD front-end errors."""


class SPDGraphError(SPDError):
    pass


# --------------------------------------------------------------------------
# Pipeline scheduling: ASAP leveling + delay balancing
# --------------------------------------------------------------------------


@dataclass
class Schedule:
    """Result of pipeline scheduling a core.

    ``ready``      variable -> cycle its value emerges from the datapath
    ``node_start`` node name -> cycle its (aligned) inputs enter
    ``node_delay`` node name -> pipeline latency through the node
    ``balance_regs`` total inserted delay registers (32-bit words x cycles)
    ``depth``      pipeline depth d of the core (max over outputs, all outputs
                   padded to this depth as hardware would)
    """

    ready: dict[str, int]
    node_start: dict[str, int]
    node_delay: dict[str, int]
    balance_regs: int
    depth: int


# Delay/resource oracles for HDL modules whose cost depends on params (library
# modules register themselves here via repro_torch.core.library).
DelayFn = Callable[[Sequence[str], Mapping[str, float]], int]


def schedule(
    core: Core,
    hdl_delay: Callable[[Node], int],
    op_latency: Mapping[str, int] | None = None,
) -> Schedule:
    """ASAP-schedule ``core`` and balance path delays.

    ``hdl_delay`` resolves the pipeline latency of an HDL node (declared
    delay, library oracle, or recursive sub-core depth).
    """
    alias = core.alias_map()
    ready: dict[str, int] = {p: 0 for p in core.input_ports()}
    ready.update({p: 0 for p in core.params})
    node_start: dict[str, int] = {}
    node_delay: dict[str, int] = {}
    balance = 0

    for n in core.toposort():
        deps = [alias.get(v, v) for v in n.inputs]
        times = [ready[d] for d in deps]
        start = max(times, default=0)
        # Delay balancing: every earlier-arriving input gets a FIFO of
        # (start - t) stages so all operands meet in the same cycle.
        balance += sum(start - t for t in times)
        d = expr_depth(n.expr, op_latency) if n.kind == "equ" else hdl_delay(n)
        node_start[n.name] = start
        node_delay[n.name] = d
        for v in n.outputs:
            ready[v] = start + d

    outs = []
    for p in core.output_ports():
        src = alias.get(p, p)
        if src not in ready:
            raise SPDGraphError(f"core {core.name}: output '{p}' undriven")
        ready[p] = ready[src]
        outs.append(ready[p])
    depth = max(outs, default=0)
    # Hardware pads all outputs to the common depth.
    balance += sum(depth - t for t in outs)
    return Schedule(ready, node_start, node_delay, balance, depth)


def op_census(
    core: Core,
    hdl_census: Callable[[Node], Mapping[str, int]],
) -> dict[str, int]:
    """Total FP-operator counts for a core (recursing into HDL nodes)."""
    total: dict[str, int] = {}
    for n in core.nodes:
        part = expr_op_census(n.expr) if n.kind == "equ" else hdl_census(n)
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def flop_count(census: Mapping[str, int]) -> int:
    """FP operators per streamed element (sqrt/div each count once)."""
    return sum(census.values())
