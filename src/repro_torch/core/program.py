"""Streaming program graphs: multi-core fusion and pipelining as one layer.

The port of the JAX package's ``core/program.py`` (docs/pipeline.md
§program, DESIGN.md §14; the port's design is docs/port.md §program). The
paper's DSL is hierarchical — full applications are chains of stream
cores, and the DSE picks the parallelism mix for the whole structure. A
:class:`StreamProgram` takes a chain of compiled SPD cores (producer →
consumer edges with per-edge stencil extents) and lowers each *fusion
cluster* of a partition to one generated stream kernel:

* **fused** — a cluster's member stages are chained inside one stripe
  body, by synthesizing an SPD wrapper core that calls the member cores in
  sequence (the sub-core chaining idiom of ``apps.lbm.pe_spd``) with edge
  extents realized as ``Stencil2D`` nodes; the wrapper compiles through
  the ordinary :class:`~repro_torch.core.codegen.StreamKernel` path, so
  stencil-offset inference composes the member halos and the launch is
  the standard ``m``-blocked streamed launch.
* **pipelined** — clusters on either side of a *cut* edge run as chained
  launches: each program step launches every cluster at ``m = 1``, back to
  back on the current stream, so intermediate fields stay on the card.
  The reference runs the chain as one jitted ``fori_loop``; the port
  captures one program step as a CUDA graph on static buffers and replays
  it ``steps`` times, with no host synchronization (docs/port.md
  §program).

The fusion partition (``"3"`` fully fused, ``"1+2"``, ``"1+1+1"`` fully
pipelined — :func:`repro_torch.core.legalize.parse_fusion`) is a plan
dimension: legalized by
:func:`~repro_torch.core.legalize.program_blocking_plan`, priced by
``GPUModel.evaluate(..., fusion=)`` cluster by cluster, and searched
through the ``repro_torch.core.search`` strategies.

Supported graphs: linear chains (every stage has one producer and one
consumer edge); diamond and fan-out programs raise :class:`ProgramError`.
The state's device picks the path, as everywhere in the port: a CUDA
state launches the generated cluster kernels, a CPU state runs their
plain versions.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Sequence

import torch

from .codegen import CodegenError, StreamKernel, stencil_summary
from .compiler import CompiledCore, Registry
from .dfg import SPDError
from .legalize import parse_fusion, resolve_run_plan
from .spd import parse_spd


class ProgramError(SPDError):
    """The core DAG cannot be lowered as a stream program (with why)."""


def fusion_partitions(nstages: int) -> tuple[str, ...]:
    """All fusion partition specs of an ``nstages``-stage chain.

    The 2^(n-1) ordered compositions of ``nstages``, as canonical
    ``"+"``-joined specs — ``fusion_partitions(3)`` is ``('3', '2+1',
    '1+2', '1+1+1')`` (fully fused first, fully pipelined last): the
    fusion axis the sweep lattice enumerates.
    """

    def _comps(n):
        if n == 0:
            yield ()
            return
        for first in range(n, 0, -1):
            for rest in _comps(n - first):
                yield (first,) + rest

    return tuple(
        "+".join(str(s) for s in comp) for comp in _comps(int(nstages))
    )


@dataclass(frozen=True)
class ProgramStage:
    """One stage of a stream program: a compiled core plus the
    ``(dy, dx)`` stencil extent of its incoming producer edge (``(0, 0)``
    for the source stage — there is no edge feeding it)."""

    compiled: CompiledCore
    extent: tuple[int, int] = (0, 0)

    @property
    def name(self) -> str:
        return self.compiled.core.name


class StreamProgram:
    """A producer→consumer chain of SPD cores, lowerable per fusion
    partition (docs/pipeline.md §program, docs/port.md §program).

    ``stages`` are compiled cores (or registry names) sharing one
    registry; ``edges`` are ``(producer, consumer)`` or ``(producer,
    consumer, (dy, dx))`` tuples over stage indices or names, validated to
    form the linear chain ``0 → 1 → … → n-1`` (``None`` means the chain
    with zero extents). Every stage must be stream-lowerable on its own
    and all stages must agree on the main port count ``P``.
    ``Append_Reg`` scalars concatenate in stage order into one flat
    program register tuple; cluster kernels slice their members' span.
    ``device`` is where the cluster kernels' :meth:`ProgramKernel.pack`
    puts new state (``"cuda"`` without a card raises).
    """

    def __init__(self, registry: Registry, stages: Sequence,
                 edges: Sequence | None = None, *, width: int = 0,
                 name: str = "program", device="cuda"):
        from repro_torch.interop import resolve_device

        self.registry = registry
        self.name = str(name)
        self.width = int(width)
        self.device = resolve_device(device)
        resolved = []
        for s in stages:
            if isinstance(s, str):
                s = registry.lookup(s)
            if not isinstance(s, CompiledCore):
                raise ProgramError(
                    f"program stage {s!r} is not a compiled SPD core"
                )
            resolved.append(s)
        if not resolved:
            raise ProgramError("a stream program needs >= 1 stage")
        names = [c.core.name for c in resolved]
        if len(set(names)) != len(names):
            raise ProgramError(f"duplicate stage cores: {names}")
        extents = self._chain_extents(names, edges)
        self.stages: tuple[ProgramStage, ...] = tuple(
            ProgramStage(c, e) for c, e in zip(resolved, extents)
        )
        ports = None
        for st in self.stages:
            core = st.compiled.core
            if core.brch_input_ports() or core.brch_output_ports():
                raise ProgramError(
                    f"stage {core.name}: branch streams are not "
                    "lowerable in a stream program"
                )
            if len(core.main_input_ports()) != len(core.main_output_ports()):
                raise ProgramError(
                    f"stage {core.name}: |main_in| != |main_out| "
                    f"({len(core.main_input_ports())} != "
                    f"{len(core.main_output_ports())}); program edges "
                    "chain outputs into the consumer's inputs"
                )
            if ports is None:
                ports = len(core.main_input_ports())
            elif len(core.main_input_ports()) != ports:
                raise ProgramError(
                    f"stage {core.name} has {len(core.main_input_ports())} "
                    f"main ports, chain carries {ports}; all stages of a "
                    "program share one (P, H, W) stream shape"
                )
            if st.extent != (0, 0) and not self.width:
                raise ProgramError(
                    f"edge into stage {core.name} has extent {st.extent}; "
                    "non-zero edge extents need the program's grid "
                    "width (StreamProgram(..., width=W)) to synthesize "
                    "their Stencil2D nodes"
                )
        self.P = ports
        self._cluster_kernels: dict[tuple[int, int], StreamKernel] = {}
        self._program_kernels: dict[str, "ProgramKernel"] = {}
        self._rings: dict[tuple, list[torch.Tensor]] = {}
        #: Held while a run enqueues its work on a ring: runs from two
        #: threads on one stream then reach the card one after the other.
        self.ring_lock = threading.Lock()

    @staticmethod
    def _chain_extents(names, edges):
        """Validate the edge set as the linear chain; per-stage extents."""
        n = len(names)
        if edges is None:
            return [(0, 0)] * n
        index = {nm: i for i, nm in enumerate(names)}
        extents = [(0, 0)] * n
        seen = set()
        for e in edges:
            if len(e) == 2:
                prod, cons = e
                ext = (0, 0)
            else:
                prod, cons, ext = e
            prod = index[prod] if isinstance(prod, str) else int(prod)
            cons = index[cons] if isinstance(cons, str) else int(cons)
            if cons != prod + 1 or not (0 <= prod < n - 1):
                raise ProgramError(
                    f"edge {prod}->{cons} is not a chain edge; stream "
                    "programs support linear chains (stage i feeds "
                    "stage i+1) — diamond/fan-out DAGs are not lowerable"
                )
            if (prod, cons) in seen:
                raise ProgramError(f"duplicate edge {prod}->{cons}")
            seen.add((prod, cons))
            dy, dx = ext
            extents[cons] = (int(dy), int(dx))
        if len(seen) != n - 1:
            missing = [
                (i, i + 1) for i in range(n - 1) if (i, i + 1) not in seen
            ]
            raise ProgramError(
                f"program edges leave the chain disconnected: missing "
                f"{missing}"
            )
        return extents

    # ---- per-stage geometry (the legalizer/model contract) ----------------

    @property
    def nstages(self) -> int:
        return len(self.stages)

    def stage_halo(self, k: int) -> int:
        """Per-step stencil reach of stage ``k`` *through* its incoming
        edge: the stage's own inferred halo composed with the producer
        edge's extent (:func:`~repro_torch.core.codegen.stencil_summary`
        memoizes on the pair)."""
        st = self.stages[k]
        return stencil_summary(
            st.compiled, incoming=(st.extent,) * self.P
        ).halo()

    def stage_geometry(self) -> tuple[tuple[int, int], ...]:
        """``(words, halo)`` per stage, in chain order — the ``stages``
        argument of :func:`repro_torch.core.legalize.program_blocking_plan`:
        every stage stripes the full ``P``-channel state, and a fused
        cluster's composed halo is the sum of its members' entries."""
        return tuple(
            (self.P, self.stage_halo(k)) for k in range(self.nstages)
        )

    # ---- cluster synthesis -------------------------------------------------

    def _cluster_spd(self, lo: int, hi: int) -> str:
        """SPD text of the wrapper core fusing stages [lo, hi).

        The member cores are chained as sub-core calls (the ``pe_spd``
        idiom); each stage's incoming-edge extent — including the *cut*
        edge feeding the cluster when ``lo > 0`` — becomes a per-port
        ``Stencil2D`` node ahead of the stage call, so every program edge
        is applied exactly once across any partition.
        """
        xin = [f"x{j}" for j in range(self.P)]
        yout = [f"y{j}" for j in range(self.P)]
        lines = [
            f"Name {self.name}_f{lo}_{hi};",
            f"Main_In {{mi::{','.join(xin)}}};",
            f"Main_Out {{mo::{','.join(yout)}}};",
        ]
        regs = [
            f"s{k}_{r}"
            for k in range(lo, hi)
            for r in self.stages[k].compiled.core.regs
        ]
        if regs:
            lines.append(f"Append_Reg {{rg::{','.join(regs)}}};")
        cur = xin
        for k in range(lo, hi):
            dy, dx = self.stages[k].extent if k > 0 else (0, 0)
            if (dy, dx) != (0, 0):
                nxt = [f"e{k}_{j}" for j in range(self.P)]
                for j in range(self.P):
                    lines.append(
                        f"HDL E{k}_{j}, 0, ({nxt[j]}) = "
                        f"Stencil2D({cur[j]}), dy={dy}, dx={dx}, "
                        f"W={self.width}, mode=wrap;"
                    )
                cur = nxt
            outs = yout if k == hi - 1 else [
                f"t{k}_{j}" for j in range(self.P)
            ]
            args = cur + [
                f"s{k}_{r}" for r in self.stages[k].compiled.core.regs
            ]
            lines.append(
                f"HDL S{k}, 0, ({','.join(outs)}) = "
                f"{self.stages[k].name}({','.join(args)});"
            )
            cur = outs
        return "\n".join(lines) + "\n"

    def cluster_kernel(self, lo: int, hi: int) -> StreamKernel:
        """The :class:`StreamKernel` of the fused span [lo, hi), cached
        per span so partitions sharing a cluster share one kernel (and
        one built library)."""
        if not (0 <= lo < hi <= self.nstages):
            raise ProgramError(f"bad cluster span [{lo}, {hi})")
        key = (lo, hi)
        if key not in self._cluster_kernels:
            compiled = self.registry.compile(
                parse_spd(self._cluster_spd(lo, hi))
            )
            self._cluster_kernels[key] = StreamKernel(compiled,
                                                      device=self.device)
        return self._cluster_kernels[key]

    def monolithic_kernel(self) -> StreamKernel:
        """The fully fused single-core kernel — the program's reference
        semantics (one stripe body chaining every stage)."""
        return self.cluster_kernel(0, self.nstages)

    def spans(self, fusion: str = "") -> tuple[tuple[int, int], ...]:
        """The ``[lo, hi)`` stage spans of a partition's clusters."""
        spans, lo = [], 0
        for s in parse_fusion(fusion, self.nstages):
            spans.append((lo, lo + s))
            lo += s
        return tuple(spans)

    def ring(self, state, k: int) -> list[torch.Tensor]:
        """``k`` static state buffers shaped like ``state`` on its device:
        the pipelined graphs' ring (docs/port.md §program). One ring per
        shape, dtype and device, grown to the largest ``k`` asked for and
        shared by every partition's graphs, so the graphs of a search
        hold at most ``nstages`` state-sized buffers."""
        key = (tuple(state.shape), state.dtype, str(state.device))
        bufs = self._rings.setdefault(key, [])
        while len(bufs) < k:
            bufs.append(torch.zeros(state.shape, dtype=state.dtype,
                                    device=state.device))
        return bufs[:k]

    def kernel(self, fusion: str = "") -> "ProgramKernel":
        """The program lowered under a fusion partition, cached per
        canonical spec (``""`` means fully fused)."""
        sizes = parse_fusion(fusion, self.nstages)
        spec = "+".join(str(s) for s in sizes)
        if spec not in self._program_kernels:
            self._program_kernels[spec] = ProgramKernel(self, spec)
        return self._program_kernels[spec]

    # ---- registers ---------------------------------------------------------

    def reg_names(self) -> tuple[str, ...]:
        """Flat program register names, stage order (``s{k}_{reg}``)."""
        return tuple(
            f"s{k}_{r}"
            for k, st in enumerate(self.stages)
            for r in st.compiled.core.regs
        )

    def reg_slice(self, lo: int, hi: int) -> slice:
        """Span of the flat register tuple owned by stages [lo, hi)."""
        counts = [len(st.compiled.core.regs) for st in self.stages]
        return slice(sum(counts[:lo]), sum(counts[:hi]))

    # ---- DSE hand-off ------------------------------------------------------

    def workload(self, elems: int, grid_w: int = 0):
        """Bind the program to a stream length: a
        :class:`~repro_torch.core.dse.StreamWorkload` whose ``stages``
        carry the per-stage (flops, words, halo) triples the fusion-aware
        model prices cluster by cluster, and whose ``cluster_tiles`` carry
        every span's Hopper tile (the ``smem`` rule, priced per cluster)."""
        from .dse import StreamWorkload

        reports = [st.compiled.hardware_report for st in self.stages]
        stage_geom = tuple(
            (r.flops, self.P, self.stage_halo(k))
            for k, r in enumerate(reports)
        )
        tiles = []
        for lo in range(self.nstages):
            for hi in range(lo + 1, self.nstages + 1):
                prog = self.cluster_kernel(lo, hi).program
                tiles.append(((lo, hi), (
                    prog.halo, prog.halo_x,
                    prog.launch_planes(streamed=True, double_buffer=False),
                    prog.guard_rows,
                )))
        return StreamWorkload(
            name=self.name,
            flops_per_elem=sum(r.flops for r in reports),
            words_in=self.P,
            words_out=self.P,
            depth=sum(r.depth for r in reports),
            buffer_bits=sum(r.buffer_bits for r in reports),
            elems=int(elems),
            grid_w=int(grid_w),
            halo=sum(h for _, _, h in stage_geom),
            stages=stage_geom,
            cluster_tiles=tuple(tiles),
        )

    def explorer(self, elems: int, grid_w: int = 0, **kw):
        """A DSE :class:`~repro_torch.core.explorer.Explorer` over this
        program — ``sweep_gpu(fusion_values=...)`` adds the partition to
        the lattice and ``search`` executes points through
        :func:`program_run_factory`."""
        from .explorer import Explorer

        kw.setdefault("core", self)
        return Explorer(self.workload(elems, grid_w), **kw)


class _StepGraph:
    """One program step of a pipelined partition captured as a CUDA graph.

    ``bufs`` is a ring of ``k`` static state buffers (two for a 2-cluster
    chain): cluster ``i`` reads ``bufs[i]`` and writes ``bufs[(i + 1) %
    k]``, so a step starts and ends in ``bufs[0]`` and no launch writes its
    own input. ``launched`` lists the ``(wrapper, core name)`` of every
    launch the capture recorded: a replay launches those kernels without
    calling their wrapper, so :meth:`replay` counts them.
    """

    def __init__(self, graph, bufs, launched):
        self.graph, self.bufs, self.launched = graph, bufs, launched

    def replay(self) -> None:
        from repro_torch.kernels.spd_stream.spd_stream import count

        self.graph.replay()
        for fn, name in self.launched:
            count(fn, name)


class ProgramKernel:
    """A :class:`StreamProgram` lowered under one fusion partition.

    A single-cluster partition runs as the ordinary ``m``-blocked streamed
    launch of the fused wrapper kernel; a multi-cluster partition runs
    *pipelined* — every cluster launched once per program step at ``m =
    1``, intermediates on the card, one step captured as a CUDA graph and
    replayed (docs/port.md §program). :meth:`run_unfused` is the naive
    baseline (every intermediate through the host) the pipelined path is
    clocked against.
    """

    def __init__(self, program: StreamProgram, fusion: str = ""):
        self.program = program
        sizes = parse_fusion(fusion, program.nstages)
        self.fusion = "+".join(str(s) for s in sizes)
        self.spans = program.spans(self.fusion)
        self.clusters = tuple(
            program.cluster_kernel(a, b) for a, b in self.spans
        )
        #: max per-cluster composed halo (info; legalization reads the
        #: per-stage geometry, the launches read each cluster kernel's own
        #: inferred halo).
        self.halo = max(k.halo for k in self.clusters)
        self._graphs: dict[tuple, _StepGraph] = {}

    @property
    def pipelined(self) -> bool:
        return len(self.clusters) > 1

    def _scals(self, regs: Sequence) -> tuple:
        names = self.program.reg_names()
        if len(regs) != len(names):
            raise CodegenError(
                f"program {self.program.name}: expected {len(names)} "
                f"register values {names}, got {len(regs)}"
            )
        return tuple(
            kern._scal(tuple(regs)[self.program.reg_slice(a, b)])
            for kern, (a, b) in zip(self.clusters, self.spans)
        )

    def _step(self, state, scals, bufs, *, block_h, double_buffer):
        """One program step: every cluster once at ``m = 1``. ``bufs``
        (the CUDA path) are the ring the launches write into; ``None``
        (the CPU path) allocates each plain version's result."""
        from repro_torch.kernels.spd_stream.streaming import (
            spd_multistep_streamed,
        )

        k = len(self.clusters)
        s = state
        for i, (kern, scal) in enumerate(zip(self.clusters, scals)):
            s = spd_multistep_streamed(
                kern.program, s, scal, m=1, block_h=block_h,
                double_buffer=double_buffer,
                out=None if bufs is None else bufs[(i + 1) % k],
            )
        return s

    def _graph(self, state, scals, *, block_h, double_buffer) -> _StepGraph:
        """The CUDA graph of one program step for this state's shape and
        device, the plan and the register values (captured once: the
        registers travel by value in the captured launches). Its buffers
        are the program's ring for this shape (:meth:`StreamProgram.ring`),
        shared by every graph of every partition.

        Before capture, one eager step on the ring builds every cluster's
        library, plans its tiles and sets the kernels' shared-memory
        attributes, so the capture allocates nothing and makes no call
        that synchronizes. A capture that fails raises: there is no eager
        fallback on the card.
        """
        from repro_torch.kernels.spd_stream.spd_stream import recording

        key = (tuple(state.shape), str(state.device), int(block_h),
               bool(double_buffer), scals)
        entry = self._graphs.get(key)
        if entry is not None:
            return entry
        kw = dict(block_h=block_h, double_buffer=double_buffer)
        bufs = self.program.ring(state, len(self.clusters))
        with torch.cuda.device(state.device):
            self._step(bufs[0], scals, bufs, **kw)  # warm-up, not captured
            graph = torch.cuda.CUDAGraph()
            try:
                with recording() as launched, torch.cuda.graph(graph):
                    self._step(bufs[0], scals, bufs, **kw)
            except Exception as err:
                raise RuntimeError(
                    f"program {self.program.name} partition "
                    f"{self.fusion!r}: capturing one program step as a CUDA "
                    f"graph failed ({err}); the card path has no eager "
                    "fallback"
                ) from err
        entry = _StepGraph(graph, bufs, launched)
        self._graphs[key] = entry
        return entry

    def _pipelined(self, state, scals, *, steps, block_h, double_buffer):
        """``steps`` program steps, every cluster launched once per step
        at ``m = 1`` (temporal blocking does not cross a cut edge). On the
        card: replays of the captured step graph, on the current stream,
        with no host synchronization; on the CPU: the same chain through
        the plain versions."""
        if state.device.type == "cpu":
            for _ in range(steps):
                state = self._step(state, scals, None, block_h=block_h,
                                   double_buffer=double_buffer)
            return state
        g = self._graph(state, scals, block_h=block_h,
                        double_buffer=double_buffer)
        with self.program.ring_lock:
            g.bufs[0].copy_(state)
            for _ in range(steps):
                g.replay()
            return g.bufs[0].clone()

    def run_blocked(self, state, regs: Sequence = (), *, steps: int,
                    m: int, block_h: int, double_buffer: bool = True,
                    d: int = 1, dx: int = 1, devices: Sequence | None = None):
        """Advance ``steps`` program steps under this partition.

        Fused (one cluster): the standard ``m``-blocked launch chain.
        Pipelined: the per-step cluster chain (``m`` bounds the
        host-visible dispatch granularity but does not change the
        arithmetic: a program step is always one pass through every
        cluster). ``d > 1`` shards every cluster launch across the device
        mesh ``(d // dx, dx)`` over ``devices`` (default ``cuda:0 …
        cuda:d-1``, or the CPU ``d`` times for a CPU state; docs/port.md
        §distribute).
        """
        scals = self._scals(regs)  # validates the register count
        if d > 1:
            return self._run_sharded(
                state, regs, steps=steps, m=m, block_h=block_h,
                double_buffer=double_buffer, d=d, dx=dx, devices=devices,
            )
        if not self.pipelined:
            (a, b), kern = self.spans[0], self.clusters[0]
            return kern.run_blocked(
                state, tuple(regs)[self.program.reg_slice(a, b)],
                steps=steps, m=m, block_h=block_h,
                double_buffer=double_buffer,
            )
        return self._pipelined(
            state, scals, steps=int(steps), block_h=int(block_h),
            double_buffer=bool(double_buffer),
        )

    def _run_sharded(self, state, regs, *, steps, m, block_h, double_buffer,
                     d, dx=1, devices=None):
        if devices is None and state.device.type == "cpu":
            devices = [state.device] * d
        shard = [kern.sharded(d, devices=devices, dx=dx)
                 for kern in self.clusters]
        if not self.pipelined:
            (a, b), = self.spans
            return shard[0].run_blocked(
                state, tuple(regs)[self.program.reg_slice(a, b)],
                steps=steps, m=m, block_h=block_h,
                double_buffer=double_buffer,
            )
        # Pipelined + sharded: each cluster advances one program step per
        # sharded launch; the state stays on the mesh's first device.
        for _ in range(int(steps)):
            for sk, (a, b) in zip(shard, self.spans):
                state = sk.run_blocked(
                    state, tuple(regs)[self.program.reg_slice(a, b)],
                    steps=1, m=1, block_h=block_h,
                    double_buffer=double_buffer,
                )
        return state

    def run_unfused(self, state, regs: Sequence = (), *, steps: int,
                    block_h: int, double_buffer: bool = True):
        """The no-pipelining baseline: one launch per cluster per step,
        every intermediate field copied to the host and back
        (``.cpu()`` then ``.to(device)``) — what a program run as
        unrelated single-core runs costs."""
        from repro_torch.kernels.spd_stream.streaming import (
            spd_multistep_streamed,
        )

        scals = self._scals(regs)
        device = state.device
        for _ in range(int(steps)):
            for kern, scal in zip(self.clusters, scals):
                out = spd_multistep_streamed(
                    kern.program, state, scal, m=1, block_h=block_h,
                    double_buffer=double_buffer,
                )
                state = out.cpu().to(device)  # the host round trip
        return state

    def tile(self, width: int, block_h: int, m: int, *,
             double_buffer: bool = True) -> bool:
        """Fit every cluster's column tile to shared memory at the
        partition's per-cluster fused-step count (``m`` fused, 1
        pipelined); returns whether any cluster's launch prefetches.
        ``ValueError`` when a cluster's tile fits no thread block."""
        m_c = 1 if self.pipelined else m
        return any([kern.tile(width, block_h, m_c,
                              double_buffer=double_buffer)[1]
                    for kern in self.clusters])

    def run_for_point(self, state, regs: Sequence = (), *, point,
                      steps: int | None = None):
        """Advance the grid using a DSE design point, legalized for the
        whole partition via
        :func:`repro_torch.core.legalize.program_blocking_plan` (every
        cluster's composed-halo stripe set must fit), then each cluster's
        column tile fitted to shared memory (:meth:`tile`), dropping to
        the single-buffer launch when no cluster's prefetching tile fits.
        Returns ``(result, (block_h, m, double_buffer))``.
        """
        *_, h, w = state.shape
        block_h, m, nsteps, double_buffer = resolve_run_plan(
            h, point, steps, width=w,
            stages=self.program.stage_geometry(), fusion=self.fusion,
        )
        double_buffer = self.tile(w, block_h, m,
                                  double_buffer=double_buffer)
        out = self.run_blocked(
            state, regs, steps=nsteps, m=m, block_h=block_h,
            double_buffer=double_buffer,
        )
        return out, (block_h, m, double_buffer)

    def reference(self, state, regs: Sequence = (), *, m: int = 1):
        """``m`` program steps through the compiler's reference path of
        the fully fused wrapper (``CompiledCore.apply`` on whole grids) —
        the semantics every partition must reproduce bit for bit."""
        return self.program.monolithic_kernel().reference(
            state, regs, m=m
        )

    def pack(self, arrays: Sequence) -> torch.Tensor:
        """Stack per-port (H, W) grids into the (P, H, W) program state."""
        return self.program.monolithic_kernel().pack(arrays)


def program_run_factory(program: StreamProgram, state, regs):
    """Adapt a program and initial state into the search runner's
    ``run_factory(nsteps, m, block_h, d, double_buffer, b, fusion, dx)``
    protocol (docs/pipeline.md §search): the fusion partition selects the
    cached :class:`ProgramKernel`, everything else parameterizes its
    launch. The state's device picks the path. The factory declines
    (returns ``None``) a batched plan (``b > 1``: as the reference's
    program back end, ``src/repro/core/program.py``, does — the batch
    axis is a single core's, docs/port.md §serve) and a plan where some
    cluster's tile fits no thread block, so a search never raises mid-run
    on an unlaunchable plan.
    """
    width = int(state.shape[-1])

    def run_factory(nsteps, m, block_h, d, double_buffer=True, b=1,
                    fusion="", dx=1):
        if b > 1:
            return None
        pk = program.kernel(fusion)
        try:
            pk.tile(width, block_h, m, double_buffer=double_buffer)
        except ValueError:
            return None  # a cluster's tile fits no thread block

        def run():
            return pk.run_blocked(
                state, regs, steps=nsteps, m=m, block_h=block_h,
                double_buffer=double_buffer, d=d, dx=dx,
            )

        return run

    return run_factory


__all__ = [
    "ProgramError",
    "ProgramKernel",
    "ProgramStage",
    "StreamProgram",
    "fusion_partitions",
    "program_run_factory",
]
