"""SPD core → generated Hopper stream kernel.

The port of the JAX package's ``core/codegen.py``. ``repro_torch.core
.compiler`` lowers an SPD core to a per-point torch dataflow function; this
module lowers the same :class:`CompiledCore` one level further, into an
executable temporal-blocking CUDA kernel (docs/pipeline.md §codegen,
docs/port.md §ir). Three pieces:

1. **Stencil-offset inference** (:func:`stencil_summary`) — copied from the
   reference: an abstract interpretation of the core's DFG that tracks,
   for every main output port, the set of (dy, dx) grid offsets of the
   main inputs it reads. The per-step y-halo is ``max |dy|``, the x-halo
   ``max |dx|``.
2. **Stripe lowering** (:func:`lower_stripe`) — the DFG is flattened
   (sub-core calls inlined, variables renamed per call site) into a flat
   statement list, the IR, and split into *phases* at every ``Stencil2D``
   whose source is not a stream input: one thread per cell can read a
   neighbour's *intermediate* only once that intermediate is materialized
   over the whole tile in shared memory and the block has synchronized.
   Every stencil read inside a tile is a zero-fill shift — the
   ``_stripe_shift(periodic_x=False)`` lowering of the reference — so the
   tile's ``m·halo`` guard rows and ``m·halo_x`` guard columns supply the
   neighbours, and the cells that read the fill are the ones cropped.
   :meth:`StripeProgram.run` interprets the IR with torch over a batch of
   tiles (the plain version of the kernel); :meth:`StripeProgram
   .cuda_source` prints the *same* IR as CUDA, so the phase split, the
   zero fill and the tiling are all exercised on the CPU and only the
   printing is left to the card.
3. **Launch + legalization** — :class:`StreamKernel` hands the program to
   the streamed (:mod:`repro_torch.kernels.spd_stream.streaming`) or
   declarative (:mod:`repro_torch.kernels.spd_stream.spd_stream`) launch;
   (block_h, m) plans are legalized by the copied
   :mod:`repro_torch.core.legalize` and the column tile ``block_w`` is
   priced against the block's shared memory (docs/port.md §tile);
   :meth:`StreamKernel.sharded` runs the same program per shard of a
   device mesh (docs/port.md §distribute).

Correctness contract (``tests/test_torch_codegen.py``): on the CPU the
tiled plain version equals m applications of :meth:`CompiledCore.apply`
(:meth:`StreamKernel.reference`) bit for bit, for every legal
(block_h, block_w, m), and matches the JAX package's kernel within f32
tolerance.

Supported cores: as in the reference — no branch streams, ``|main_in| ==
|main_out|``, grid state as ``Stencil2D`` with ``mode=wrap``; in addition
every library module on the path needs a CUDA emitter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from ..tracing import add, timed
from .compiler import CompiledCore, eval_expr, f32
from .dfg import Bin, Call, Expr, Neg, Num, SPDError, Var
from .legalize import (
    launch_cell_steps,
    launch_tile,
    resolve_run_plan,
    stripe_owned,
    tile_smem_bytes,
)
from .library import LibraryModule, f32_literal

#: 1-D stream-state modules with no 2-D stripe lowering.
_STREAM_1D = ("Delay", "StreamForward", "StreamBackward")

#: Append_Reg scalars travel by value in a fixed-size struct
#: (``SPD_MAX_REGS`` in ``csrc/spd_tile.cuh``).
MAX_REGS = 16

#: The owner layout of the generated kernels, printed into every
#: translation unit as ``SPD_THREADS``, ``SPD_CPT`` and ``SPD_MIN_BLOCKS``
#: (:meth:`StripeProgram.cuda_source`); each choice was timed against its
#: alternatives on the card (docs/port.md §tile, "Why, measured").
#:
#: Blocks of a shared-state generated kernel one SM should hold: its 256
#: threads' registers are sized for two (``SPD_MIN_BLOCKS``), so shared
#: memory decides, and two blocks per SM beat one block of the widest
#: tile that fits. Both launches seek it when they choose ``block_w``.
BLOCKS_PER_SM = 2

#: Threads of a shared-state generated kernel's block (``SPD_THREADS``).
THREADS = 256

#: A register-state kernel's block: 1,024 threads owning 2 stripe cells
#: each (``REG_CPT``, one for a core of more than 10 state planes), their
#: registers sized for one block per SM (64 a thread), on the widest tile
#: whose stripe the owners hold. It beat 256 threads × 5 cells at two
#: blocks per SM, 512 × 2 and 512 × 4 at one, and shared state.
REG_THREADS = 1024
REG_CPT = 2


class CodegenError(SPDError):
    """The core cannot be lowered to a stream kernel (with the reason)."""


# --------------------------------------------------------------------------
# Stencil-offset inference
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StencilSummary:
    """What a core's outputs read from the streamed grid.

    ``port_reads`` maps each output port to the set of
    ``(input_port, dy, dx)`` triples it (transitively) consumes:
    "this output reads that input at grid offset (y−dy, x−dx)".
    ``offsets`` is the union of all (dy, dx); ``halo_y``/``halo_x`` are
    the per-step stencil reach (``max |dy|`` / ``max |dx|``);
    ``modes`` collects the boundary modes of every Stencil2D crossed.
    """

    port_reads: Mapping[str, frozenset]
    offsets: frozenset
    halo_y: int
    halo_x: int
    modes: frozenset

    def halo(self) -> int:
        """Rows of halo one application of the core consumes per side."""
        return self.halo_y


def _normalize_incoming(incoming, n: int) -> tuple:
    """Canonical per-input ``(dy, dx)`` extents tuple for memo keys.

    ``None`` (the single-core case: inputs arrive straight off the grid)
    normalizes to all-zero extents — the same key as an explicit
    all-zero request, so both spellings share one memo entry.
    """
    if incoming is None:
        return ((0, 0),) * n
    ext = tuple((int(dy), int(dx)) for dy, dx in incoming)
    if len(ext) != n:
        raise CodegenError(
            f"incoming extents cover {len(ext)} inputs, core has {n}"
        )
    return ext


def _core_reads(compiled: CompiledCore, incoming=None) -> dict[str, set]:
    """Per-output ``(input_index, dy, dx)`` read sets of one core.

    Abstract interpretation over the toposorted DFG: every variable
    carries the set of (core-input index, dy, dx) it transitively reads.
    Indices are positions in ``core.input_ports()`` (main + brch + regs);
    register/param inputs are scalars and carry the empty set.

    ``incoming`` is the per-main-input ``(dy, dx)`` extent the producer
    edge applies before this core sees the stream (docs/pipeline.md
    §program): input ``i`` seeds at ``(i, dy_i, dx_i)`` instead of
    ``(i, 0, 0)``, so a program stage's summary composes its upstream
    edge reach.

    Memoized per (compiled core, incoming extents): sub-cores are shared
    across call sites (and cascades repeat the same PE m times), so
    without the cache the walk would re-derive every callee's read set
    at every call site — and fusion clusters reuse one sub-core at
    *different* incoming extents, so the memo must key on the pair, not
    the core alone, or the second use would read the first use's stale
    offsets.
    """
    core = compiled.core
    key = _normalize_incoming(
        incoming,
        len(core.main_input_ports()) + len(core.brch_input_ports()),
    )
    memo = getattr(compiled, "_stencil_reads_memo", None)
    if memo is None:
        memo = {}
        compiled._stencil_reads_memo = memo
    cached = memo.get(key)
    if cached is not None:
        return cached
    alias = core.alias_map()
    main = set(core.main_input_ports()) | set(core.brch_input_ports())
    env: dict[str, set] = {}
    stream_idx = 0
    for i, p in enumerate(core.input_ports()):
        if p in main:
            dy, dx = key[stream_idx]
            stream_idx += 1
            env[p] = {(i, dy, dx)}
        else:
            env[p] = set()
    for p in core.params:
        env[p] = set()

    for node in core.toposort():
        ins = [env[alias.get(v, v)] for v in node.inputs]
        merged = set().union(*ins) if ins else set()
        if node.kind == "equ":
            env[node.outputs[0]] = merged
            continue
        mod = compiled.registry.lookup(node.module)
        if isinstance(mod, LibraryModule):
            if mod.name in _STREAM_1D:
                raise CodegenError(
                    f"core {core.name}: node {node.name} uses 1-D stream "
                    f"module {mod.name}; express grid state as Stencil2D "
                    "for stream codegen"
                )
            if mod.name == "Stencil2D":
                p = mod.resolve_params(node, core.params)
                dy, dx = int(p.get("dy", 0)), int(p.get("dx", 0))
                env[node.outputs[0]] = {
                    (i, oy + dy, ox + dx) for (i, oy, ox) in ins[0]
                }
            else:
                # Library modules other than the stencil buffer are
                # pointwise over the stream (mux, comparator, fixed-
                # function units): offsets pass through unchanged.
                for o in node.outputs:
                    env[o] = merged
        else:
            # Sub-core call: compose the callee's per-output read sets
            # with this call site's argument offsets (additive).
            sub = _core_reads(mod)
            sub_outs = mod.core.output_ports()
            if len(sub_outs) != len(node.outputs):
                raise CodegenError(
                    f"node {node.name}: module {node.module} has "
                    f"{len(sub_outs)} outputs, node declares "
                    f"{len(node.outputs)}"
                )
            for o_port, o_var in zip(sub_outs, node.outputs):
                acc: set = set()
                for (i, dy, dx) in sub[o_port]:
                    acc.update(
                        (j, oy + dy, ox + dx) for (j, oy, ox) in ins[i]
                    )
                env[o_var] = acc

    reads = {p: env[alias.get(p, p)] for p in core.output_ports()}
    memo[key] = reads
    return reads


def _stencil_modes(compiled: CompiledCore) -> set:
    """Boundary modes of every Stencil2D reachable from ``compiled``."""
    core = compiled.core
    modes: set = set()
    for node in core.nodes:
        if node.kind != "hdl":
            continue
        mod = compiled.registry.lookup(node.module)
        if isinstance(mod, LibraryModule):
            if mod.name == "Stencil2D":
                p = mod.resolve_params(node, core.params)
                if int(p.get("dy", 0)) or int(p.get("dx", 0)):
                    modes.add(str(p.get("mode", "zero")))
        else:
            modes |= _stencil_modes(mod)
    return modes


def stencil_summary(compiled: CompiledCore,
                    incoming=None) -> StencilSummary:
    """Infer the stencil footprint of a compiled core's DFG.

    Walks the graph once (recursing into sub-cores, memoized per
    (core, incoming extents)) and returns which input ports each output
    reads at which grid offsets, plus the halo the temporal-blocking
    kernel must carry per fused step. Cached on the compiled core:
    ``stream_halo``, ``stream_kernel()`` and direct callers all share
    one walk. ``incoming`` composes producer-edge ``(dy, dx)`` extents
    into the footprint (docs/pipeline.md §program) — a program stage's
    effective halo is its own reach *through* the edge feeding it.
    """
    core = compiled.core
    key = _normalize_incoming(
        incoming,
        len(core.main_input_ports()) + len(core.brch_input_ports()),
    )
    memo = getattr(compiled, "_stencil_summary_memo", None)
    if memo is None:
        memo = {}
        compiled._stencil_summary_memo = memo
    cached = memo.get(key)
    if cached is not None:
        return cached
    names = core.input_ports()
    reads = {
        port: frozenset((names[i], dy, dx) for (i, dy, dx) in triples)
        for port, triples in _core_reads(compiled, key).items()
    }
    offsets = frozenset(
        (dy, dx) for triples in reads.values() for (_, dy, dx) in triples
    )
    summary = StencilSummary(
        port_reads=reads,
        offsets=offsets,
        halo_y=max((abs(dy) for dy, _ in offsets), default=0),
        halo_x=max((abs(dx) for _, dx in offsets), default=0),
        modes=frozenset(_stencil_modes(compiled)),
    )
    memo[key] = summary
    return summary


# --------------------------------------------------------------------------
# Stripe lowering: the IR
# --------------------------------------------------------------------------

#: C spellings of the formula calls, mirroring ``compiler._CALL_IMPL``.
_CALL_C = {
    "sqrt": lambda a: f"sqrtf({a[0]})",
    "rsqrt": lambda a: f"(1.0f / sqrtf({a[0]}))",
    "abs": lambda a: f"fabsf({a[0]})",
    "exp": lambda a: f"expf({a[0]})",
    "min": lambda a: f"fminf({a[0]}, {a[1]})",
    "max": lambda a: f"fmaxf({a[0]}, {a[1]})",
}


@dataclass(frozen=True)
class Stmt:
    """One IR statement.

    ``op`` is ``"equ"`` (``expr`` over operand keys), ``"lib"`` (a library
    module's pointwise ``mod`` on ``ins``) or ``"shift"`` (``outs[0][y, x]
    = ins[0][y-dy, x-dx]`` inside the tile, zero fill outside).
    """

    op: str
    outs: tuple
    ins: tuple = ()
    expr: Expr | None = None
    mod: LibraryModule | None = None
    params: tuple = ()
    dy: int = 0
    dx: int = 0


class StripeProgram:
    """A compiled core lowered to phased per-cell statements.

    Operand keys: ``in<p>`` (state plane p of the current step), ``r<i>``
    (Append_Reg i), ``k<j>`` (an f32 constant) and ``v<n>`` (a per-cell
    variable). ``phases`` is the statement list cut at every stencil read
    of an intermediate; ``mat`` lists the variables that cross a phase
    boundary and so live in shared memory (``K = len(mat)`` planes).

    ``launches`` counts launches of the generated tile function by core
    name, through either launch (the stripe body of docs/port.md §ir).
    """

    launches: dict[str, int] = {}

    def __init__(self, name: str, nports: int, nregs: int, halo: int,
                 halo_x: int, phases: list, outputs: list,
                 consts: dict):
        self.name = name
        self.P = nports
        self.nregs = nregs
        self.halo = halo
        self.halo_x = halo_x
        self.phases = phases
        self.outputs = outputs
        self.consts = consts
        defined = {}
        for k, phase in enumerate(phases):
            for st in phase:
                for o in st.outs:
                    defined[o] = k
        self._defined = defined
        used: dict[str, set] = {}
        for k, phase in enumerate(phases):
            keys = set()
            for st in phase:
                keys.update(_stmt_reads(st))
            if k == len(phases) - 1:
                keys.update(outputs)
            used[k] = keys
        self._used = used
        self.mat = sorted(
            {key for k, keys in used.items() for key in keys
             if key in defined and defined[key] < k},
            key=lambda v: int(v[1:]),
        )
        # The last phase reads the state pointwise only (every stencil
        # read of the step is of an intermediate, done by then), so a step
        # may write its result over its input: one state buffer, not two.
        self.in_place = not any(_reads_state_by_stencil(st)
                                for st in phases[-1])
        # No phase reads the state by stencil: each cell's state is read
        # by that cell alone, so a thread may keep its cells' state in
        # registers across the m steps (docs/port.md §ir).
        self.reg_state = not any(_reads_state_by_stencil(st)
                                 for phase in phases for st in phase)
        self.cpt = (REG_CPT if self.P <= 10 else 1) if self.reg_state else 1
        self.threads = REG_THREADS if self.reg_state else THREADS
        self.blocks_per_sm = 1 if self.reg_state else BLOCKS_PER_SM
        self._tiles: dict[tuple, tuple[int, bool]] = {}
        self._lib = None

    @classmethod
    def count_launch(cls, name: str) -> None:
        cls.launches[name] = cls.launches.get(name, 0) + 1

    @property
    def K(self) -> int:
        return len(self.mat)

    def planes(self, nbuf: int) -> int:
        """Shared-memory planes of one tile: ``nbuf`` state buffers of P
        planes plus the K materialized intermediates."""
        return nbuf * self.P + self.K

    def launch_planes(self, *, streamed: bool, double_buffer: bool) -> int:
        """Planes a launch's tile holds (``spd_tile_planes`` of
        ``csrc/spd_stream.cuh``): ``P + K`` for a :attr:`reg_state` core
        (one load slot beside the registers, the same for a tile too large
        for the owners, whose state is stepped in the slot); otherwise one
        state buffer in place (:attr:`in_place`) or two ping/pong, plus
        the second ring slot in a streamed launch with ``double_buffer``."""
        if self.reg_state:
            return self.planes(1)
        state = 1 if self.in_place else 2
        return self.planes(state + bool(streamed and double_buffer))

    @property
    def owner_cells(self) -> int:
        """Stripe cells a block's threads own in registers (0 when the
        core keeps its state in shared memory)."""
        return self.threads * self.cpt if self.reg_state else 0

    def owned(self, block_h: int, block_w: int, m: int) -> bool:
        """Whether a tile's state lives in the owners' registers: a
        :attr:`reg_state` core on a stripe of at most :attr:`owner_cells`
        cells (:func:`~repro_torch.core.legalize.stripe_owned`)."""
        return stripe_owned(block_h, block_w, m, halo=self.halo,
                            halo_x=self.halo_x, owner_cells=self.owner_cells)

    @property
    def guard_rows(self) -> int:
        """Rows of ``C`` cells before the first plane and after the last
        that keep every stencil tap inside the allocation
        (``SPD_GUARD_ROWS``)."""
        return 2 * (self.halo + 1)

    def smem_bytes(self, block_h: int, block_w: int, m: int, *,
                   streamed: bool, double_buffer: bool) -> int:
        """Dynamic shared memory of one launch's tile."""
        return tile_smem_bytes(
            block_h, block_w, m, halo=self.halo, halo_x=self.halo_x,
            planes=self.launch_planes(streamed=streamed,
                                      double_buffer=double_buffer),
            guard_rows=self.guard_rows)

    # ---- the plain version: torch over a batch of tiles -------------------

    def run(self, tiles: torch.Tensor, regs: Sequence) -> torch.Tensor:
        """One application of the core over ``(T, P, R, C)`` tiles."""
        regs_t = [f32(v, tiles.device) for v in regs]
        consts = {k: f32(v, tiles.device) for k, v in self.consts.items()}
        mat: dict = {}

        for k, phase in enumerate(self.phases):
            local: dict = {}

            def get(key, local=local):
                if key.startswith("in"):
                    return tiles[:, int(key[2:])]
                if key.startswith("r"):
                    return regs_t[int(key[1:])]
                if key.startswith("k"):
                    return consts[key]
                if key in local:
                    return local[key]
                if key in mat:
                    return mat[key]
                raise CodegenError(
                    f"{self.name}: phase {k} reads {key}, which is neither "
                    "local nor materialized"
                )

            for st in phase:
                if st.op == "equ":
                    local[st.outs[0]] = eval_expr(
                        st.expr, _KeyEnv(get), tiles.device
                    )
                elif st.op == "lib":
                    outs = st.mod.apply([get(i) for i in st.ins],
                                        dict(st.params))
                    local.update(zip(st.outs, outs))
                else:
                    src = st.ins[0]
                    if src in local:
                        raise CodegenError(
                            f"{self.name}: stencil read of {src} in the "
                            "phase that defines it"
                        )
                    local[st.outs[0]] = _tile_shift(get(src), st.dy, st.dx)
            for key in self.mat:
                if self._defined[key] == k:
                    mat[key] = local[key]
        shape = tiles.shape[:1] + tiles.shape[2:]
        outs = [get(o).to(torch.float32).expand(shape)
                for o in self.outputs]
        return torch.stack(outs, dim=1)

    # ---- the CUDA printer --------------------------------------------------

    def cuda_source(self) -> str:
        """The generated translation unit: the owner layout, the
        ``SpdCore`` tile steps, then the shared launch scaffolding of
        ``csrc/spd_stream.cuh``.

        ``step`` walks the cells ``t, t + SPD_THREADS, …`` of a tile whose
        state lies in shared memory; a :attr:`reg_state` core also gets
        ``step_owned``, which steps its owned cells' state in registers.
        Every stencil tap is one shared load at a constant offset from the
        cell (``csrc/spd_tile.cuh``).
        """
        reg = self.reg_state
        L = [
            f"// Generated from SPD core {self.name} by "
            "repro_torch.core.codegen; do not edit.",
            f"#define SPD_THREADS {self.threads}",
        ]
        if reg:
            L.append(f"#define SPD_CPT {self.cpt}")
        L += [f"#define SPD_MIN_BLOCKS {self.blocks_per_sm}",
              '#include "spd_tile.cuh"', ""]
        flag = lambda b: "true" if b else "false"  # noqa: E731
        L += [
            "struct SpdCore {",
            f"  static constexpr int P = {self.P};",
            f"  static constexpr int K = {self.K};",
            f"  static constexpr int HALO = {self.halo};",
            f"  static constexpr int HALO_X = {self.halo_x};",
            f"  static constexpr bool IN_PLACE = {flag(self.in_place)};",
            f"  static constexpr bool REG_STATE = {flag(reg)};",
            f"  static constexpr int CPT = {'SPD_CPT' if reg else 1};",
            "  static __device__ __forceinline__ void step(",
            # src and dst are one buffer when the step runs in place
            "      const float* src, float* dst,",
            "      float* __restrict__ mat, const SpdTile& t,",
            "      const SpdRegs& regs) {",
        ]
        dims = "    const int C = t.C, RC = t.RC;"
        L.append(dims)
        for k in range(len(self.phases)):
            # one thread per cell, cells SPD_THREADS apart
            L += [f"    // phase {k}",
                  "    for (int idx = threadIdx.x; idx < RC; "
                  "idx += SPD_THREADS) {"]
            body = self._phase_body(
                k, lambda p: f"src[{p} * RC + idx]",
                lambda p, v: f"dst[{p} * RC + idx] = {v};")
            L.extend("      " + line for line in body)
            L += ["    }", "    __syncthreads();"]
        L.append("  }")
        if reg:
            L += [
                "  // The owned cells' state in registers: s[q] is cell",
                "  // t + q SPD_THREADS of the tile, owned while < RC.",
                "  static __device__ __forceinline__ void step_owned(",
                "      float (&s)[CPT][P],",
                "      float* __restrict__ mat, const SpdTile& t,",
                "      const SpdRegs& regs) {",
                dims,
            ]
            for k in range(len(self.phases)):
                L += [f"    // phase {k}", "#pragma unroll",
                      "    for (int q = 0; q < CPT; ++q) {",
                      "      const int idx = threadIdx.x + q * SPD_THREADS;",
                      "      if (idx >= RC) continue;"]
                body = self._phase_body(
                    k, lambda p: f"s[q][{p}]",
                    lambda p, v: f"s[q][{p}] = {v};")
                L.extend("      " + line for line in body)
                L += ["    }", "    __syncthreads();"]
            L.append("  }")
        L += ["};", "", '#include "spd_stream.cuh"', ""]
        return "\n".join(L)

    def _phase_body(self, k: int, state, store) -> list:
        """Phase ``k`` of one cell ``idx``: its pointwise reads (a state
        plane through ``state(p)``), statements, taps, materialized
        stores and, in the last phase, the new state (``store(p, v)``)."""
        mat_idx = {v: j for j, v in enumerate(self.mat)}

        def name(key):
            if key.startswith("r"):
                return f"regs.v[{key[1:]}]"
            if key.startswith("k"):
                return f32_literal(self.consts[key])
            return key

        def tap(key, dy, dx):
            arr, p = (("src", int(key[2:])) if key.startswith("in")
                      else ("mat", mat_idx[key]))
            return f"{arr}[{p} * RC + idx - ({dy} * C + ({dx}))]"

        last = k == len(self.phases) - 1
        pointwise = set()
        for st in self.phases[k]:
            if st.op != "shift":
                pointwise.update(_stmt_reads(st))
        if last:
            pointwise.update(self.outputs)
        body = []
        for key in sorted(pointwise, key=_key_order):
            if key.startswith("in"):
                body.append(f"const float {key} = {state(key[2:])};")
            elif key in mat_idx and self._defined[key] < k:
                body.append(f"const float {key} = mat[{mat_idx[key]} "
                            "* RC + idx];")
        for st in self.phases[k]:
            if st.op == "equ":
                body.append(f"const float {st.outs[0]} = "
                            f"{_expr_c(st.expr, name)};")
            elif st.op == "lib":
                body.extend(st.mod.cuda(list(st.outs),
                                        [name(i) for i in st.ins],
                                        dict(st.params)))
            else:
                body.append(f"const float {st.outs[0]} = "
                            f"{tap(st.ins[0], st.dy, st.dx)};")
        for key in self.mat:
            if self._defined[key] == k:
                body.append(f"mat[{mat_idx[key]} * RC + idx] = {key};")
        if last:
            for p, o in enumerate(self.outputs):
                body.append(store(p, name(o)))
        return body

    def tile(self, width: int, block_h: int, m: int, *,
             block_w: int | None = None, double_buffer: bool = True,
             streamed: bool = True):
        """``(block_w, double_buffer)`` of a launch of this program's
        kernel: :func:`launch_tile` priced at :meth:`launch_planes` and
        :attr:`guard_rows`, looking for room for :attr:`blocks_per_sm`
        blocks on an SM first (two for a shared-state core; one for a
        register-state core, whose registers take the SM, narrowed to the
        widest halving whose stripe the owners hold, where one does).
        ``double_buffer`` is the streamed launch's prefetch: never in the
        declarative launch, nor on a register-state core's tile too large
        for the owners (:meth:`owned`). Plans are cached per program: a
        launch at a small grid is bound by its host time."""
        key = (width, block_h, m, block_w, double_buffer, streamed)
        if key not in self._tiles:
            self._tiles[key] = self._tile(*key)
        return self._tiles[key]

    def _tile(self, width, block_h, m, block_w, double_buffer, streamed):
        return launch_tile(
            width, block_h, m, halo=self.halo, halo_x=self.halo_x,
            planes=lambda db: self.launch_planes(streamed=streamed,
                                                 double_buffer=db),
            block_w=block_w, double_buffer=double_buffer and streamed,
            blocks_per_sm=self.blocks_per_sm, guard_rows=self.guard_rows,
            owner_cells=self.owner_cells,
        )

    def library(self):
        """The compiled CUDA library of this program (built on first use)."""
        if self._lib is None:
            from repro_torch.kernels.build import load_spd_library

            self._lib = load_spd_library(self)
        return self._lib


class _KeyEnv(Mapping):
    """Read-only mapping view of an operand getter (for ``eval_expr``)."""

    def __init__(self, get):
        self._get = get

    def __getitem__(self, key):
        return self._get(key)

    def __iter__(self):
        return iter(())

    def __len__(self):
        return 0


def _reads_state_by_stencil(st: Stmt) -> bool:
    return st.op == "shift" and st.ins[0].startswith("in")


def _key_order(key: str):
    return (key[0], int(key.lstrip("invrk") or 0))


def _expr_vars(e: Expr, out: set) -> set:
    if isinstance(e, Var):
        out.add(e.name)
    elif isinstance(e, Bin):
        _expr_vars(e.lhs, out)
        _expr_vars(e.rhs, out)
    elif isinstance(e, Neg):
        _expr_vars(e.arg, out)
    elif isinstance(e, Call):
        for a in e.args:
            _expr_vars(a, out)
    return out


def _stmt_reads(st: Stmt) -> set:
    keys = set(st.ins)
    if st.expr is not None:
        _expr_vars(st.expr, keys)
    return keys


def _expr_c(e: Expr, name) -> str:
    """Print a renamed formula as C, one parenthesized f32 op per node."""
    if isinstance(e, Num):
        return f32_literal(e.value)
    if isinstance(e, Var):
        return name(e.name)
    if isinstance(e, Neg):
        return f"(-{_expr_c(e.arg, name)})"
    if isinstance(e, Bin):
        return f"({_expr_c(e.lhs, name)} {e.op} {_expr_c(e.rhs, name)})"
    if isinstance(e, Call):
        return _CALL_C[e.fn]([_expr_c(a, name) for a in e.args])
    raise TypeError(f"unknown expr {e!r}")


def _rename(e: Expr, env: Mapping, alias: Mapping, inputs) -> Expr:
    """Replace a formula's variables by operand keys (as ``eval_expr``
    resolves them: node inputs through the DRCT aliases, params direct)."""
    if isinstance(e, Var):
        src = alias.get(e.name, e.name) if e.name in inputs else e.name
        if src not in env:
            raise CodegenError(f"unbound variable {e.name!r}")
        return Var(env[src])
    if isinstance(e, Bin):
        return Bin(e.op, _rename(e.lhs, env, alias, inputs),
                   _rename(e.rhs, env, alias, inputs))
    if isinstance(e, Neg):
        return Neg(_rename(e.arg, env, alias, inputs))
    if isinstance(e, Call):
        return Call(e.fn, tuple(_rename(a, env, alias, inputs)
                                for a in e.args))
    return e


class _Flattener:
    """Inlines a core's DFG into one statement list with fresh names."""

    def __init__(self):
        self.stmts: list[Stmt] = []
        self.consts: dict[str, float] = {}
        self._const_keys: dict[float, str] = {}
        self._n = 0

    def var(self) -> str:
        self._n += 1
        return f"v{self._n - 1}"

    def const(self, value) -> str:
        v = float(value)
        if v not in self._const_keys:
            key = f"k{len(self._const_keys)}"
            self._const_keys[v] = key
            self.consts[key] = v
        return self._const_keys[v]

    def core(self, compiled: CompiledCore, env: dict) -> list:
        core = compiled.core
        alias = core.alias_map()
        for k, v in core.params.items():
            env[k] = self.const(v)
        for node in core.toposort():
            ins = [env[alias.get(v, v)] for v in node.inputs]
            if node.kind == "equ":
                out = self.var()
                self.stmts.append(Stmt(
                    "equ", (out,),
                    expr=_rename(node.expr, env, alias, node.inputs),
                ))
                env[node.outputs[0]] = out
                continue
            mod = compiled.registry.lookup(node.module)
            if isinstance(mod, LibraryModule):
                if mod.name in _STREAM_1D:
                    raise CodegenError(
                        f"core {core.name}: node {node.name} uses 1-D stream "
                        f"module {mod.name}; not lowerable to a 2-D stripe"
                    )
                p = mod.resolve_params(node, core.params)
                if mod.name == "Stencil2D":
                    if ins[0][0] not in "iv":
                        raise CodegenError(
                            f"core {core.name}: node {node.name} stencils "
                            f"a scalar ({node.inputs[0]})"
                        )
                    outs = [self.var()]
                    self.stmts.append(Stmt(
                        "shift", tuple(outs), (ins[0],),
                        dy=int(p.get("dy", 0)), dx=int(p.get("dx", 0)),
                    ))
                else:
                    if mod.cuda is None:
                        raise CodegenError(
                            f"core {core.name}: node {node.name} uses "
                            f"library module {mod.name}, which has no CUDA "
                            "emitter"
                        )
                    nout = mod.n_out if mod.n_out >= 0 else len(node.outputs)
                    outs = [self.var() for _ in range(nout)]
                    self.stmts.append(Stmt(
                        "lib", tuple(outs), tuple(ins), mod=mod,
                        params=tuple(sorted(p.items())),
                    ))
            else:
                outs = self.core(mod, dict(zip(mod.core.input_ports(), ins)))
            if len(outs) != len(node.outputs):
                raise CodegenError(
                    f"node {node.name}: module {node.module} returned "
                    f"{len(outs)} outputs, node declares {len(node.outputs)}"
                )
            env.update(zip(node.outputs, outs))
        out = []
        for p in core.output_ports():
            src = alias.get(p, p)
            if src not in env:
                raise CodegenError(
                    f"core {core.name}: output port {p!r} undriven"
                )
            out.append(env[src])
        return out


@timed("setup.lower")
def lower_stripe(compiled: CompiledCore, halo: int,
                 halo_x: int) -> StripeProgram:
    """Flatten a core and split it into phases (docs/port.md §ir)."""
    core = compiled.core
    if len(core.regs) > MAX_REGS:
        raise CodegenError(
            f"core {core.name}: {len(core.regs)} Append_Reg values exceed "
            f"the kernel's by-value limit of {MAX_REGS}"
        )
    ports = core.main_input_ports()
    env = {p: f"in{i}" for i, p in enumerate(ports)}
    env.update({r: f"r{i}" for i, r in enumerate(core.regs)})
    fl = _Flattener()
    outputs = fl.core(compiled, env)[:len(ports)]
    for p, o in zip(core.main_output_ports(), outputs):
        if o[0] in "rk":
            raise CodegenError(
                f"core {core.name}: output port {p!r} is a scalar, not a "
                "stream"
            )
    _check_reach(core.name, fl.stmts, outputs, halo, halo_x)
    phases: list[list[Stmt]] = [[]]
    phase_of: dict[str, int] = {}
    for st in fl.stmts:
        if st.op == "shift" and phase_of.get(st.ins[0]) == len(phases) - 1:
            phases.append([])  # the source must be materialized first
        phases[-1].append(st)
        for o in st.outs:
            phase_of[o] = len(phases) - 1
    return StripeProgram(core.name, len(ports), len(core.regs), halo,
                         halo_x, phases, outputs, fl.consts)


def _check_reach(name: str, stmts, outputs, halo: int,
                 halo_x: int) -> None:
    """Refuse a core whose chained stencil reads reach farther than the
    composed halo (a shift and its opposite cancel in the halo, not in the
    reads): the tile's guard cells would not cover them, and the kernel's
    taps read outside the tile only in cells that the guard crops."""
    reach: dict[str, tuple] = {}
    for st in stmts:
        ry = rx = 0
        for key in _stmt_reads(st):
            y, x = reach.get(key, (0, 0))
            ry, rx = max(ry, y), max(rx, x)
        if st.op == "shift":
            ry, rx = ry + abs(st.dy), rx + abs(st.dx)
        for o in st.outs:
            reach[o] = (ry, rx)
    ry = max((reach.get(o, (0, 0))[0] for o in outputs), default=0)
    rx = max((reach.get(o, (0, 0))[1] for o in outputs), default=0)
    if ry > halo or rx > halo_x:
        raise CodegenError(
            f"core {name}: its stencil reads reach ({ry}, {rx}) cells, "
            f"beyond the composed halo ({halo}, {halo_x}); the tile's guard "
            "cells would not cover them"
        )


def _tile_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[..., y, x] = in[..., y-dy, x-dx]`` on a tile, zero fill.

    The ``_stripe_shift(periodic_x=False)`` of the reference on the last
    two axes: the tile's guard rows and columns hold the true neighbour
    values, and the cells that consume the fill are the ones cropped.
    """
    if x.dim() < 2:
        return x
    rows, cols = x.shape[-2:]
    out = torch.zeros_like(x)
    y0, y1 = max(0, dy), rows + min(0, dy)
    x0, x1 = max(0, dx), cols + min(0, dx)
    if y0 < y1 and x0 < x1:
        out[..., y0:y1, x0:x1] = x[..., y0 - dy:y1 - dy, x0 - dx:x1 - dx]
    return out


def gather_tiles(state: torch.Tensor, block_h: int, block_w: int,
                 mh: int, mw: int, *, guard: bool = False) -> torch.Tensor:
    """Cut ``(P, H, W)`` into ``(T, P, R, C)`` tiles with guard cells.

    Tile ``(by, bx)`` (row-major, ``T = (H / block_h)·ceil(W / block_w)``)
    covers rows ``by·block_h - mh ...`` and columns ``bx·block_w - mw ...``,
    both taken mod the grid — the periodic stripe assembly of the
    reference's ``src_starts``, extended to columns.

    ``guard=True`` cuts a guard-block-extended shard (the halo launches,
    docs/port.md §distribute): the first and last ``block_h`` rows are
    guard blocks, tile ``by`` covers rows ``(by + 1)·block_h - mh ...``
    with no wrap, and ``T = (H / block_h - 2)·ceil(W / block_w)``.
    """
    _, h, w = state.shape
    nby, nbx = h // block_h, math.ceil(w / block_w)
    dev = state.device
    if guard:
        nby -= 2
    rows = (torch.arange(nby, device=dev)[:, None] * block_h - mh
            + torch.arange(block_h + 2 * mh, device=dev))
    rows = rows + block_h if guard else rows % h
    cols = (torch.arange(nbx, device=dev)[:, None] * block_w - mw
            + torch.arange(block_w + 2 * mw, device=dev)) % w
    t = state[:, rows[:, None, :, None], cols[None, :, None, :]]
    return t.permute(1, 2, 0, 3, 4).reshape(
        nby * nbx, state.shape[0], block_h + 2 * mh, block_w + 2 * mw
    )


def scatter_centers(tiles: torch.Tensor, h: int, w: int, block_h: int,
                    block_w: int, mh: int, mw: int) -> torch.Tensor:
    """Crop every tile's center and reassemble the ``(P, H, W)`` grid
    (the ragged last column tile is masked to the grid width)."""
    nby, nbx = h // block_h, math.ceil(w / block_w)
    p = tiles.shape[1]
    c = tiles[:, :, mh:mh + block_h, mw:mw + block_w]
    c = c.reshape(nby, nbx, p, block_h, block_w).permute(2, 0, 3, 1, 4)
    return c.reshape(p, h, nbx * block_w)[:, :, :w].contiguous()


# --------------------------------------------------------------------------
# The codegen'd kernel
# --------------------------------------------------------------------------


def count_plan(program, rows: int, width: int, cols: int, block_h: int,
               block_w: int, m: int, steps: int, *, tiles: int = 1) -> None:
    """Add a run's cell-steps at its launch plan to the program counters
    (``repro_torch.tracing``): ``plan.useful_cell_steps``, the updates it
    keeps (``tiles`` grids of ``rows × cols`` cells over ``steps``), and
    ``plan.executed_cell_steps``, what its ``steps // m`` launches of
    ``program`` over ``width`` columns step, halo rows and guard columns
    included (:func:`~repro_torch.core.legalize.launch_cell_steps`). Their
    ratio is the plan's recompute. Once a run, not once a launch."""
    add("plan.executed_cell_steps", steps // m * launch_cell_steps(
        rows, width, block_h, block_w, m, halo=program.halo,
        halo_x=program.halo_x, b=tiles))
    add("plan.useful_cell_steps", tiles * rows * cols * steps)


class StreamKernel:
    """A compiled SPD core lowered to a temporal-blocking Hopper kernel.

    Obtained via :meth:`CompiledCore.stream_kernel`. The grid state is a
    stacked ``(P, H, W)`` f32 tensor with one channel per main-stream port
    (in ``main_in`` order), or a ``(B, P, H, W)`` batch of B independent
    simulations (:meth:`pack_batch`) that :meth:`__call__`,
    :meth:`multistep`, :meth:`run_blocked` and :meth:`run_for_point` run
    in one launch each, every member bitwise as it runs alone
    (docs/port.md §serve); ``Append_Reg`` values are passed as a scalar
    tuple, shared by every member. One fused launch (:meth:`__call__`)
    advances ``m`` time steps per HBM round trip; :meth:`run_for_point`
    legalizes and runs a DSE design point (docs/pipeline.md §execute).
    The state tensor's device picks the path: a CUDA tensor launches the
    generated kernel, a CPU tensor runs its plain version. ``device`` is
    where :meth:`pack` puts new state; ``"cuda"`` without a card raises.
    """

    def __init__(self, compiled: CompiledCore, device="cuda"):
        from repro_torch.interop import resolve_device

        core = compiled.core
        if core.brch_input_ports() or core.brch_output_ports():
            raise CodegenError(
                f"core {core.name}: branch streams are not lowerable to a "
                "stream kernel (no per-element side channel on the grid)"
            )
        if len(core.main_input_ports()) != len(core.main_output_ports()):
            raise CodegenError(
                f"core {core.name}: |main_in| != |main_out| "
                f"({len(core.main_input_ports())} != "
                f"{len(core.main_output_ports())}); fused steps chain "
                "outputs back into inputs"
            )
        self.compiled = compiled
        self.summary = stencil_summary(compiled)
        bad = self.summary.modes - {"wrap"}
        if bad:
            raise CodegenError(
                f"core {core.name}: Stencil2D mode(s) {sorted(bad)} not "
                "supported; the stream kernel's y-halo is periodic "
                "(mode=wrap). Express walls via stream attributes."
            )
        self.halo = self.summary.halo()
        self.halo_x = self.summary.halo_x
        self._ports = core.main_input_ports()
        self._regs = list(core.regs)
        self.program = lower_stripe(compiled, self.halo, self.halo_x)
        self.device = resolve_device(device)
        self._sharded: dict[tuple[int, int], object] = {}

    # ---- launches ----------------------------------------------------------

    def _scal(self, regs: Sequence) -> tuple:
        if len(regs) != len(self._regs):
            raise CodegenError(
                f"core {self.compiled.core.name}: expected "
                f"{len(self._regs)} register values {self._regs}, "
                f"got {len(regs)}"
            )
        return tuple(float(r) for r in regs)

    def __call__(self, state, regs: Sequence = (), *, m: int = 1,
                 block_h: int = 32, block_w: int | None = None,
                 double_buffer: bool = True):
        """One fused launch: advance ``state`` by ``m`` time steps.

        ``double_buffer`` picks the streamed launch's prefetch protocol
        (docs/pipeline.md §stream); both are bitwise identical to the
        declarative launch (:meth:`multistep`).
        """
        from repro_torch.kernels.spd_stream.streaming import (
            spd_multistep_streamed,
        )

        return spd_multistep_streamed(
            self.program, state, self._scal(regs), m=m, block_h=block_h,
            block_w=block_w, double_buffer=double_buffer,
        )

    def multistep(self, state, regs: Sequence = (), *, m: int = 1,
                  block_h: int = 32, block_w: int | None = None):
        """The declarative launch: one thread block per tile."""
        from repro_torch.kernels.spd_stream.spd_stream import spd_multistep

        return spd_multistep(
            self.program, state, self._scal(regs), m=m, block_h=block_h,
            block_w=block_w,
        )

    def run_blocked(self, state, regs: Sequence = (), *, steps: int,
                    m: int, block_h: int, double_buffer: bool = True):
        """Advance ``steps`` time steps using m-fused kernel launches."""
        from repro_torch.kernels.spd_stream.ops import stream_run_blocked

        return stream_run_blocked(
            self.program, state, self._scal(regs), steps=int(steps),
            m=int(m), block_h=int(block_h),
            double_buffer=bool(double_buffer),
        )

    def sharded(self, d: int, devices: Sequence | None = None,
                dx: int = 1):
        """Decompose this kernel across ``d`` devices.

        Returns a :class:`repro_torch.core.distribute.ShardedStreamKernel`
        running this kernel's tile function per shard, with halo exchange
        between fused launches (docs/port.md §distribute). ``dx`` factors
        ``d`` into a ``(dy, dx)`` mesh. ``devices`` may repeat a device
        (``["cuda:0"] * 4`` runs a (2, 2) mesh on one card); ``None``
        takes ``cuda:0 … cuda:d-1``, or the CPU d times for a kernel on
        the CPU. ``d == 1`` delegates straight back. Default-device
        wrappers are cached per ``(d, dx)``.
        """
        from .distribute import ShardedStreamKernel

        if devices is not None:
            return ShardedStreamKernel(self, d, devices, dx=dx)
        if (d, dx) not in self._sharded:
            self._sharded[(d, dx)] = ShardedStreamKernel(self, d, dx=dx)
        return self._sharded[(d, dx)]

    def run_for_point(self, state, regs: Sequence = (), *, point,
                      steps: int | None = None):
        """Advance the grid using a DSE design point's (block_h, m).

        The point is legalized with the shared :func:`resolve_run_plan`
        using this kernel's inferred halo; the column tile is then fitted
        to the block's shared memory (docs/port.md §tile), dropping to the
        single-buffer launch when no prefetching tile fits. Returns
        ``(result, (block_h, m, double_buffer))``.
        """
        _check_state(state, len(self._ports), batch=True)
        h, w = state.shape[-2:]
        block_h, m, nsteps, double_buffer = resolve_run_plan(
            h, point, steps, halo=self.halo, dx=1,
        )
        block_w, double_buffer = self.tile(w, block_h, m,
                                           double_buffer=double_buffer)
        count_plan(self.program, h, w, w, block_h, block_w, m, nsteps,
                   tiles=state.shape[0] if state.dim() == 4 else 1)
        out = self.run_blocked(
            state, regs, steps=nsteps, m=m, block_h=block_h,
            double_buffer=double_buffer,
        )
        return out, (block_h, m, double_buffer)

    def tile(self, width: int, block_h: int, m: int, *,
             block_w: int | None = None, double_buffer: bool = True,
             streamed: bool = True):
        """``(block_w, double_buffer)`` of the streamed launch (of the
        declarative one with ``streamed=False``)."""
        return self.program.tile(width, block_h, m, block_w=block_w,
                                 double_buffer=double_buffer,
                                 streamed=streamed)

    # ---- the compiler's reference function --------------------------------

    def reference(self, state, regs: Sequence = (), *, m: int = 1):
        """m repeated applications of the compiled core's torch function:
        :meth:`CompiledCore.apply` on the full grid (``Stencil2D`` fully
        periodic), outputs chained into inputs, on the state's device."""
        _check_state(state, len(self._ports))
        regs = [f32(r, state.device) for r in self._scal(regs)]
        outs = [state[i] for i in range(len(self._ports))]
        for _ in range(m):
            outs = self.compiled.apply(list(outs) + regs)
        return torch.stack([
            o.to(state.dtype).expand(state.shape[1:])
            for o in outs[:len(self._ports)]
        ])

    def pack(self, arrays: Sequence) -> torch.Tensor:
        """Stack per-port (H, W) grids (numpy or torch) into the kernel's
        (P, H, W) f32 state on this kernel's device."""
        from repro_torch.interop import from_numpy

        if len(arrays) != len(self._ports):
            raise CodegenError(
                f"expected {len(self._ports)} main-stream fields "
                f"{self._ports}, got {len(arrays)}"
            )
        return torch.stack([from_numpy(a, self.device) for a in arrays])

    def pack_batch(self, states: Sequence) -> torch.Tensor:
        """Stack ``b`` packed ``(P, H, W)`` states (numpy or torch) into a
        ``(B, P, H, W)`` f32 batch on this kernel's device.

        The batch axis groups independent simulations into one launch
        (docs/port.md §serve); members must share one geometry.
        """
        from repro_torch.interop import from_numpy

        if not states:
            raise CodegenError("pack_batch needs at least one state")
        arrs = [from_numpy(s, self.device) for s in states]
        if any(a.shape != arrs[0].shape for a in arrs):
            raise CodegenError(
                "pack_batch members must share one (P, H, W) geometry; "
                f"got {[tuple(a.shape) for a in arrs]}"
            )
        return torch.stack(arrs)


def _check_state(state, nports: int, *, batch: bool = False) -> None:
    """The launches take one f32 ``(P, H, W)`` tensor; with ``batch`` (the
    two periodic launches and the runs over them) a ``(B, P, H, W)``
    batch of B independent members too (docs/port.md §serve)."""
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"state must be a torch.Tensor, got {type(state)}")
    if state.dim() == 4 and not batch:
        raise CodegenError(
            "batched (B, P, H, W) states run through the two periodic "
            "launches only (the halo launches, the mesh and the reference "
            "take one (P, H, W) member)"
        )
    if state.dim() not in (3, 4) or state.shape[-3] != nports or \
            0 in state.shape[:-3]:
        want = "([B,] " if batch else "("
        raise CodegenError(
            f"state must be {want}{nports}, H, W), got {tuple(state.shape)}"
        )
    if state.dtype != torch.float32:
        raise TypeError(f"state must be float32, got {state.dtype}")


__all__ = [
    "CodegenError",
    "StencilSummary",
    "StreamKernel",
    "StripeProgram",
    "lower_stripe",
    "stencil_summary",
]
