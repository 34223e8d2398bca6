"""Design-space exploration over (n, m) = (spatial, temporal) parallelism.

The port of the JAX package's ``core/dse.py`` (docs/port.md §dse). Two
targets are modeled:

* :class:`FPGAModel` — the paper's platform (Stratix V 5SGXEA7 + DDR3),
  calibrated against Table III: a copy of the reference. Reproduces peak
  ``P(n,m) = n*m*NFlops*F`` (Eq. 10), the bandwidth-limited utilization
  ``u(n) = min(1, BWeff/(n*BWpipe))``, the resource constraints
  (DSP/ALM/BRAM), and a power model fit to the six measured
  configurations, from which perf/W and the paper's winning
  configuration (n, m) = (1, 4) fall out.

* :class:`GPUModel` — the port's platform, one NVIDIA H100 SXM (the
  reference's ``TPUModel`` with the card's constants). Temporal
  parallelism becomes *temporal blocking* (m fused time-steps per HBM
  round trip with an m-deep halo, see ``repro_torch.kernels.spd_stream``);
  spatial parallelism becomes parallel tiles and cards. The model keeps
  the reference's roofline equations and its VMEM feasibility check (the
  legalizer keeps ``VMEM_BYTES`` for plan parity), and adds one rule of
  the card: a point whose smallest column tile exceeds a thread block's
  shared memory (:data:`~repro_torch.core.legalize.SMEM_BYTES`) is
  infeasible (limit ``smem``).

All numbers flow from a :class:`StreamWorkload`, which is produced directly
from a compiled SPD core's :class:`~repro_torch.core.compiler.HardwareReport`.

Both models expose two evaluation surfaces:

* ``evaluate(w, ...)`` — one scalar design point, returning a rich
  :class:`DesignPoint` (limits, detail dict).
* ``evaluate_batch(w, ...)`` — the same arithmetic over *arrays* of
  coordinates, returning a dict of NumPy arrays with no per-point Python
  loops. ``repro_torch.core.explorer`` sweeps whole (n, m, block) lattices
  through this path and extracts Pareto frontiers from the result; the
  scalar and batched paths agree point for point
  (``tests/test_torch_dse.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from .legalize import (
    SMEM_BYTES,
    VMEM_BYTES,
    cluster_vmem_bytes,
    parse_fusion,
    stripe_vmem_bytes,
    tile_smem_bytes,
)

# --------------------------------------------------------------------------
# Workload description
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StreamWorkload:
    """One iterative stream computation, per pipeline (n=1, m=1)."""

    name: str
    flops_per_elem: int  # N_Flops (paper: 131)
    words_in: int  # main-stream words read per element (paper: 10)
    words_out: int  # main-stream words written per element (paper: 10)
    depth: int  # pipeline depth d of one PE (paper: 855 for x1)
    buffer_bits: int  # stencil buffer bits of one PE
    elems: int  # stream length T (paper grid: 720*300)
    grid_w: int = 0  # row width (2-D workloads; drives lane-shared buffers)
    # Per-step stencil reach in rows (repro_torch.core.codegen inference; 1
    # for LBM, 0 for elementwise cores). The GPU model's stripe residency and
    # halo-recompute terms use it, so the model and the kernel legalizer
    # (repro_torch.core.legalize) account the same stripe geometry.
    halo: int = 1
    # Per-step stencil reach in *columns* (x). ``-1`` — the default —
    # means "same as ``halo``", which is exact for every shipped core
    # (the diffusion 5-point and LBM D2Q9 stencils are symmetric), so
    # existing workload constructions stay valid. The 2-D mesh terms
    # (DESIGN.md §15) read it through :attr:`stencil_halo_x`.
    halo_x: int = -1
    # Stream-program stage chain (docs/pipeline.md §program, DESIGN.md
    # §14): per-stage ``(flops_per_elem, words, halo)`` triples in chain
    # order, produced by ``StreamProgram.workload``. Empty for a
    # single-core workload. When present, ``GPUModel.evaluate(...,
    # fusion=)`` prices fusion partitions cluster by cluster — the
    # totals above stay the fully-fused aggregates.
    stages: tuple = ()
    # The Hopper tile of the generated stream kernel (docs/port.md §dse):
    # the f32 planes one tile keeps resident in the single-buffer streamed
    # launch (``StripeProgram.launch_planes``) and its guard rows
    # (``StripeProgram.guard_rows``), filled in by
    # ``CompiledCore.stream_workload``. 0 planes: not known, priced as the
    # ping/pong state, ``2·words_in`` planes and no guard rows.
    tile_planes: int = 0
    tile_guard_rows: int = 0

    @classmethod
    def from_report(cls, report, elems: int, grid_w: int = 0) -> "StreamWorkload":
        return cls(
            name=report.name,
            flops_per_elem=report.flops,
            words_in=report.stream_in_words,
            words_out=report.stream_out_words,
            depth=report.depth,
            buffer_bits=report.buffer_bits,
            elems=elems,
            grid_w=grid_w,
            halo=getattr(report, "halo", 1),
            halo_x=int(getattr(report, "halo_x", -1)),
        )

    @property
    def stencil_halo_x(self) -> int:
        """Effective column stencil reach (``halo_x``, falling back to
        the row reach ``halo`` when unset — DESIGN.md §15)."""
        return self.halo_x if self.halo_x >= 0 else self.halo

    def tile_smem_bytes(self, block_h, m, halo_x=None):
        """Shared-memory bytes of the smallest tile a Hopper launch of
        this workload can take (``block_w`` 1, no prefetch slot), by the
        legalizer's own :func:`~repro_torch.core.legalize.tile_smem_bytes`:
        :func:`~repro_torch.core.legalize.launch_tile` raises exactly when
        this exceeds :data:`~repro_torch.core.legalize.SMEM_BYTES`.
        ``block_h``/``m`` may be arrays."""
        planes = self.tile_planes or 2 * self.words_in
        return tile_smem_bytes(
            block_h, 1, m, halo=self.halo,
            halo_x=self.stencil_halo_x if halo_x is None else halo_x,
            planes=planes, guard_rows=self.tile_guard_rows,
        )

    def fusion_clusters(self, fusion: str = "") -> list[dict]:
        """Partition ``stages`` into fusion clusters (docs/pipeline.md
        §program): each cluster dict carries its aggregate ``flops``,
        member ``words``/``halos`` lists and the *composed* halo (the
        sum of member halos — the legalizer's rule). Raises if the
        workload carries no stage chain."""
        if not self.stages:
            raise ValueError(
                f"workload {self.name!r} has no program stages; "
                "fusion pricing needs StreamProgram.workload(...)"
            )
        sizes = parse_fusion(fusion, len(self.stages))
        out, lo = [], 0
        for s in sizes:
            members = self.stages[lo:lo + s]
            lo += s
            out.append({
                "flops": sum(int(f) for f, _, _ in members),
                "words": [int(w) for _, w, _ in members],
                "halos": [int(h) for _, _, h in members],
                "halo": sum(int(h) for _, _, h in members),
            })
        return out


@dataclass
class DesignPoint:
    n: int
    m: int
    feasible: bool
    limits: list[str] = field(default_factory=list)
    peak_gflops: float = 0.0
    utilization: float = 0.0
    sustained_gflops: float = 0.0
    power_w: float = 0.0
    perf_per_watt: float = 0.0
    detail: dict = field(default_factory=dict)

    def key(self) -> tuple[int, int]:
        return (self.n, self.m)


# --------------------------------------------------------------------------
# FPGA target (paper platform), Table III-calibrated
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FPGATarget:
    name: str = "stratix-v-5sgxea7"
    alms: int = 234_720
    regs: int = 938_880
    bram_bits: int = 52_428_800
    dsps: int = 256
    freq_ghz: float = 0.18
    # DDR3-800 x 512bit: 12.8 GB/s nominal per direction; the measured
    # effective per-direction bandwidth backed out of Table III's
    # utilizations (0.557*2*7.2 = 8.02, 0.279*4*7.2 = 8.03) is ~8.02 GB/s.
    bw_nominal_gbs: float = 12.8
    bw_eff_gbs: float = 8.02
    # SoC peripherals (PCIe, DDR3 controllers, DMA) from Table III.
    soc_alms: int = 54_997
    soc_regs: int = 87_163
    soc_bram_bits: int = 3_110_753
    soc_dsps: int = 0
    # Per-operator synthesis cost model (ALMs / DSPs), loosely calibrated to
    # the paper's per-pipeline footprint (~31.8 kALM, 48 DSP for 131 ops).
    alm_per_add: float = 380.0
    alm_per_mul: float = 75.0
    alm_per_div: float = 3_000.0
    alm_per_ctrl: float = 2_000.0  # per-PE stream control overhead
    dsp_per_mul: float = 0.8


# Table III (measured) — kept as data both for calibration and for the
# reproduction benchmark to diff against.
TABLE3_MEASURED = {
    # (n, m): (ALMs, Regs, BRAM bits, DSPs, utilization, GFlop/s, W, GFlop/sW)
    (1, 1): (34_310, 62_145, 573_370, 48, 0.999, 23.5, 28.1, 0.837),
    (1, 2): (63_687, 122_426, 1_243_564, 96, 0.999, 47.1, 30.6, 1.542),
    (1, 4): (129_738, 244_196, 2_987_730, 192, 0.999, 94.2, 39.0, 2.416),
    (2, 1): (64_119, 122_630, 642_410, 96, 0.557, 26.3, 32.3, 0.812),
    (2, 2): (136_742, 244_195, 1_316_604, 192, 0.558, 52.6, 37.4, 1.405),
    (4, 1): (128_431, 243_626, 859_604, 192, 0.279, 26.3, 33.2, 0.792),
}


class FPGAModel:
    """Analytic performance/power/resource model of the paper's platform."""

    def __init__(self, target: FPGATarget = FPGATarget()):
        self.target = target
        self._fit_power()

    # ---- power: W ~ c0 + c1*(n*m) + c2*sustained + c3*bw_used. Terms map to
    # static+idle board power, per-pipeline logic area, switching activity,
    # and DDR activity; least-squares over the six measured configurations
    # (R^2 ~ 0.988, max 2.3% error).
    def _fit_power(self) -> None:
        rows, y = [], []
        for (n, m), rec in TABLE3_MEASURED.items():
            rows.append([1.0, n * m, rec[5], self._bw_used(n)])
            y.append(rec[6])
        a, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(y), rcond=None)
        self.power_coef = a  # [c0, c1, c2, c3]
        pred = np.asarray(rows) @ a
        ss_res = float(np.sum((pred - np.asarray(y)) ** 2))
        ss_tot = float(np.sum((np.asarray(y) - np.mean(y)) ** 2))
        self.power_r2 = 1.0 - ss_res / ss_tot

    def _bw_used(self, n: int, words: int = 10) -> float:
        t = self.target
        demand = n * words * 4 * t.freq_ghz
        return min(demand, t.bw_eff_gbs)

    def power_w(self, n: int, m: int, sustained_gflops: float,
                words: int = 10) -> float:
        c0, c1, c2, c3 = self.power_coef
        w = float(
            c0 + c1 * n * m + c2 * sustained_gflops + c3 * self._bw_used(n, words)
        )
        # the linear fit extrapolates below the board's idle draw for tiny
        # workloads; clamp to a 20 W idle floor (paper board idles ~25 W)
        return max(w, 20.0)

    # ---- resources ---------------------------------------------------------
    def pipeline_alms(self, w: StreamWorkload, census: dict | None = None) -> float:
        t = self.target
        if census is None:
            # fall back to the paper's LBM mix if a census is not supplied
            census = {"add": 70, "mul": 60, "div": 1}
        return (
            t.alm_per_add * census.get("add", 0)
            + t.alm_per_mul * census.get("mul", 0)
            + t.alm_per_div * (census.get("div", 0) + census.get("sqrt", 0))
            + t.alm_per_ctrl
        )

    def pipeline_dsps(self, census: dict | None = None) -> int:
        if census is None:
            census = {"mul": 60}
        return int(round(self.target.dsp_per_mul * census.get("mul", 0)))

    def buffer_bits(self, w: StreamWorkload, n: int, m: int) -> int:
        """m PEs each with an n-lane *shared* buffer (paper §II-B).

        The shared buffer holds the same rows regardless of n (lanes tap the
        same lines), plus per-lane ingress/egress registers; cascading
        multiplies the whole thing by m.
        """
        per_pe = w.buffer_bits + (n - 1) * 32 * 64  # lane regs
        return m * per_pe

    # ---- performance (Eq. 10 + utilization) --------------------------------
    def evaluate(
        self,
        w: StreamWorkload,
        n: int,
        m: int,
        census: dict | None = None,
        overlapped_passes: bool = True,
    ) -> DesignPoint:
        t = self.target
        pt = DesignPoint(n=n, m=m, feasible=True)
        peak = n * m * w.flops_per_elem * t.freq_ghz  # GFlop/s (Eq. 10)

        # Bandwidth-limited utilization: an n-wide stream demands n x
        # words * 4 B * F per direction; read/write are symmetric here.
        bw_per_lane = max(w.words_in, w.words_out) * 4 * t.freq_ghz  # GB/s
        u_bw = min(1.0, t.bw_eff_gbs / (n * bw_per_lane))
        # Pipeline fill/drain: T elements through an (m*d)-deep pipeline.
        depth = m * w.depth
        u_pipe = 1.0 if overlapped_passes else w.elems / (w.elems + depth)
        u = u_bw * u_pipe
        sustained = peak * u

        # Resource feasibility.
        alms = t.soc_alms + n * m * self.pipeline_alms(w, census)
        dsps = t.soc_dsps + n * m * self.pipeline_dsps(census)
        bram = t.soc_bram_bits + self.buffer_bits(w, n, m)
        if alms > t.alms:
            pt.feasible = False
            pt.limits.append(f"ALM {alms:.0f}>{t.alms}")
        if dsps > t.dsps:
            pt.feasible = False
            pt.limits.append(f"DSP {dsps}>{t.dsps}")
        if bram > t.bram_bits:
            pt.feasible = False
            pt.limits.append(f"BRAM {bram}>{t.bram_bits}")
        if u_bw < 1.0:
            pt.limits.append("bandwidth-bound")

        power = self.power_w(n, m, sustained, words=max(w.words_in, w.words_out))
        pt.peak_gflops = peak
        pt.utilization = u
        pt.sustained_gflops = sustained
        pt.power_w = power
        pt.perf_per_watt = sustained / power if power > 0 else 0.0
        pt.detail = {
            "alms": alms,
            "dsps": dsps,
            "bram_bits": bram,
            "u_bw": u_bw,
            "u_pipe": u_pipe,
            "bw_required_gbs": n * bw_per_lane,
            "depth": depth,
        }
        return pt

    def evaluate_batch(
        self,
        w: StreamWorkload,
        n,
        m,
        census: dict | None = None,
        overlapped_passes: bool = True,
    ) -> dict[str, np.ndarray]:
        """Vectorized :meth:`evaluate` over coordinate arrays ``n``, ``m``.

        ``n`` and ``m`` are broadcast against each other; every returned
        array has the broadcast shape. The arithmetic is bit-identical to
        the scalar path (same float64 expressions, same clamps), so
        ``evaluate_batch(w, [n], [m])`` agrees with ``evaluate(w, n, m)``
        point-for-point.
        """
        t = self.target
        n = np.asarray(n, dtype=np.int64)
        m = np.asarray(m, dtype=np.int64)
        n, m = np.broadcast_arrays(n, m)
        nm = n * m

        peak = nm * float(w.flops_per_elem) * t.freq_ghz  # Eq. (10)
        words = max(w.words_in, w.words_out)
        bw_per_lane = words * 4 * t.freq_ghz
        u_bw = np.minimum(1.0, t.bw_eff_gbs / (n * bw_per_lane))
        depth = m * w.depth
        if overlapped_passes:
            u_pipe = np.ones(n.shape)
        else:
            u_pipe = w.elems / (w.elems + depth)
        u = u_bw * u_pipe
        sustained = peak * u

        alms = t.soc_alms + nm * self.pipeline_alms(w, census)
        dsps = t.soc_dsps + nm * self.pipeline_dsps(census)
        bram = t.soc_bram_bits + m * (w.buffer_bits + (n - 1) * 32 * 64)
        feasible = (alms <= t.alms) & (dsps <= t.dsps) & (bram <= t.bram_bits)

        c0, c1, c2, c3 = self.power_coef
        bw_used = np.minimum(n * words * 4 * t.freq_ghz, t.bw_eff_gbs)
        power = np.maximum(c0 + c1 * nm + c2 * sustained + c3 * bw_used, 20.0)
        ppw = np.where(power > 0, sustained / power, 0.0)
        resource_frac = np.maximum(
            np.maximum(alms / t.alms, dsps / t.dsps), bram / t.bram_bits
        )
        return {
            "n": n,
            "m": m,
            "feasible": feasible,
            "peak_gflops": peak,
            "utilization": u,
            "sustained_gflops": sustained,
            "power_w": power,
            "perf_per_watt": ppw,
            "alms": alms,
            "dsps": dsps,
            "bram_bits": bram,
            "u_bw": u_bw,
            "u_pipe": u_pipe,
            "bw_required_gbs": n * bw_per_lane,
            "depth": depth,
            "resource_frac": resource_frac,
        }

    def explore(
        self,
        w: StreamWorkload,
        n_values: Sequence[int] = (1, 2, 4),
        m_values: Sequence[int] = (1, 2, 4),
        census: dict | None = None,
    ) -> list[DesignPoint]:
        pts = [
            self.evaluate(w, n, m, census)
            for n in n_values
            for m in m_values
        ]
        return sorted(
            pts, key=lambda p: (p.feasible, p.perf_per_watt), reverse=True
        )


# --------------------------------------------------------------------------
# GPU target (the port's hardware adaptation, docs/port.md §dse)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GPUTarget:
    """One NVIDIA H100 SXM (80 GB HBM3), in the fields of the reference's
    ``TPUTarget``.

    Rates are NVIDIA's data-sheet peaks for the SXM part, dense, at its
    700 W power limit; a card set below it (``nvidia-smi --query-gpu=
    power.limit``) runs slower under load. ``vpu_f32_tflops`` keeps its
    name and role: the FP32 rate outside the tensor cores, which the
    stream kernels' elementwise f32 math runs at. ``vmem_bytes`` is the
    reference's plan budget, kept because the legalizer keeps
    ``VMEM_BYTES`` for plan parity; ``smem_bytes`` is what one thread
    block can use, the card's own capacity term.
    """

    name: str = "h100-sxm"
    peak_bf16_tflops: float = 989.0
    vpu_f32_tflops: float = 67.0
    hbm_gbs: float = 3350.0
    vmem_bytes: int = VMEM_BYTES
    # One NVLink 4 link: 900 GB/s over 18 links (both directions).
    ici_gbs_per_link: float = 50.0
    hbm_bytes_per_chip: int = 80 * 10**9
    # Per-card power for the perf/W frontier axis: an assumed idle floor
    # plus activity proportional to the achieved fraction of the FP32
    # roof, up to the 700 W limit. The floor is not measured; like the
    # reference's assumed board powers it only ranks points.
    chip_idle_w: float = 100.0
    chip_peak_w: float = 700.0
    # Dispatch latency per extra launch in an m-step block (0.0: every
    # single-launch prediction is the roofline's, as in the reference).
    launch_overhead_s: float = 0.0
    smem_bytes: int = SMEM_BYTES


class GPUModel:
    """Roofline model of temporal blocking (the cascaded-PE analogue).

    The reference's ``TPUModel`` equations at :class:`GPUTarget`'s
    constants. A block of ``bh`` rows is made resident on chip; ``m``
    fused time-steps are applied before writing back, so HBM traffic per
    element is constant in m while compute scales with m — the paper's
    temporal parallelism argument, with on-chip memory playing the BRAM
    role and the halo (2m rows, recomputed) playing the prologue/epilogue
    role. A point is infeasible where the reference's VMEM budget, the
    mesh geometry or the block's shared memory (``smem``) refuses it.
    """

    def __init__(self, target: GPUTarget = GPUTarget()):
        self.target = target

    @classmethod
    def calibrated(
        cls, calibration, d: int = 1, base: GPUTarget | None = None
    ) -> "GPUModel":
        """A model whose target carries *measured* platform constants.

        ``calibration`` is a :class:`repro_torch.core.measure.BackendCalibration`
        (anything with a ``target(d, base)`` method): the returned model
        predicts against the effective throughput/bandwidth of the
        platform actually running — the plain torch versions on the CPU,
        the generated kernels on the card — so predicted-vs-measured is a
        model-fidelity signal, not a ratio of two platforms' speeds
        (docs/pipeline.md §measure, DESIGN.md §9).
        """
        return cls(calibration.target(d=d, base=base))

    def evaluate(
        self,
        w: StreamWorkload,
        bh: int,
        m: int,
        d: int = 1,
        double_buffer: bool = True,
        b: int = 1,
        fusion: str = "",
        dx: int = 1,
    ) -> DesignPoint:
        """One (block_h, m, d, b, fusion, dx) design point. ``d`` is the
        device axis — the *total* number of chips; ``dx`` factors it
        into a ``(dy, dx) = (d // dx, dx)`` mesh (DESIGN.md §15): rows
        shard across ``dy`` as before, columns across ``dx``. ``dx == 1``
        reproduces the 1-D ring numbers bit-for-bit. Under ``dx > 1``
        the per-shard width ``grid_w / dx`` drives the VMEM stripe (plus
        ``2·m·halo_x`` guard columns), the useful fraction gains the
        column trapezoid factor ``w_s / (w_s + 2·m·halo_x)``, and the
        collective term prices the two exchanges separately — the column
        exchange volume scales with shard *height*, the row exchange
        with shard *width*, which is what lets the model pick
        aspect-matched meshes. ``b`` is the batch axis —
        the number of independent simulations stacked into one launch
        (docs/pipeline.md §serve): compute, HBM traffic and VMEM
        residency all scale linearly with ``b``, and the VMEM term is
        priced by the legalizer's own ``stripe_vmem_bytes(..., b=b)``
        so modeled and executed geometry agree.

        ``fusion`` prices a stream-program partition (docs/pipeline.md
        §program, DESIGN.md §14; needs ``w.stages``). Fused (one
        cluster): one HBM pass per m-step block, stripes summed at the
        composed halo — more VMEM, less traffic. Pipelined (k > 1
        clusters): every *cut* edge costs a full-grid HBM write + read
        per program step — ``m·k`` passes per m-step block — while each
        cluster's temporal block collapses to one step (halo recompute
        shrinks) and VMEM holds only the largest cluster's stripes.
        """
        t = self.target
        d = int(d)
        dx = max(1, int(dx))
        b = max(1, int(b))
        pt = DesignPoint(n=d, m=m, feasible=True)
        grid_w = w.grid_w or int(math.sqrt(w.elems))
        bytes_per_elem = 4 * (w.words_in + w.words_out)
        clusters = w.fusion_clusters(fusion) if w.stages else None
        fusion = (
            "+".join(str(s) for s in parse_fusion(fusion, len(w.stages)))
            if w.stages else ""
        )

        # Mesh factorization (DESIGN.md §15): d chips arrange as a
        # (dy, dx) mesh. dx must divide the device count and the width —
        # the sharded kernel hard-errors on both, so the model marks
        # non-factorizing points infeasible instead of pricing them.
        hx = w.stencil_halo_x
        dy = max(d // dx, 1)
        shard_w = max(grid_w // dx, 1)
        if d % dx:
            pt.feasible = False
            pt.limits.append(f"mesh {d}%dx={dx}!=0")
        if dx > 1 and (not w.grid_w or grid_w % dx):
            pt.feasible = False
            pt.limits.append(f"colshard {grid_w}%{dx}!=0")

        # The dy axis decomposes the grid along y into dy equal shards
        # (halo-exchanged between cards). A height dy does not divide has no
        # executable geometry — the sharded kernel rejects it — so the
        # model marks it infeasible instead of pricing an impossible run.
        if w.grid_w and dy > 1 and (w.elems // w.grid_w) % dy:
            pt.feasible = False
            pt.limits.append(f"shard {w.elems // w.grid_w}%{dy}!=0")

        # A block taller than the shard cannot be clamped into the
        # launch geometry (``resolve_run_plan`` clamps *within* the
        # shard height) — a dy-heavy mesh on a short grid caps the
        # legal block_h, which is exactly why wide grids prefer column
        # sharding (DESIGN.md §15). Non-tiling-but-smaller blocks stay
        # feasible: the runner clamps them to a legal divisor.
        if w.grid_w and dy > 1:
            shard_h = (w.elems // w.grid_w) // dy
            if shard_h and bh > shard_h:
                pt.feasible = False
                pt.limits.append(f"block {bh}>shard_h={shard_h}")

        # The batched leading dim runs through the single-device stream
        # kernels only; a batched *and* sharded launch has no executable
        # geometry (repro_torch.core.distribute handles (P, H, W) state).
        if b > 1 and d > 1:
            pt.feasible = False
            pt.limits.append(f"batched b={b} + sharded d={d} unsupported")

        # VMEM residency: priced by the legalizer's own stripe formula
        # (repro_torch.core.legalize) — one source of truth, so a feasible
        # point is never silently shrunk at run time and model/legalizer
        # budgets cannot drift apart. Programs price each cluster's
        # stripe *set* at its composed halo and keep the max (clusters
        # launch one at a time).
        guard = hx if dx > 1 else 0  # guard columns only when column-sharded
        if clusters is None:
            vmem = stripe_vmem_bytes(
                bh, m, shard_w, w.words_in, halo=w.halo,
                double_buffer=double_buffer, b=b, halo_x=guard,
            )
        else:
            m_c = m if len(clusters) == 1 else 1
            vmem = max(
                cluster_vmem_bytes(
                    bh, m_c, shard_w, c["words"], c["halos"],
                    double_buffer, b=b,
                )
                for c in clusters
            )
        if vmem > t.vmem_bytes:
            pt.feasible = False
            pt.limits.append(f"VMEM {vmem}>{t.vmem_bytes}")
        # Shared memory (docs/port.md §dse): the smallest column tile of
        # the Hopper launch must fit one thread block; where it does not,
        # launch_tile raises, so the point has no executable plan.
        smem = int(w.tile_smem_bytes(bh, m))
        if smem > t.smem_bytes:
            pt.feasible = False
            pt.limits.append(f"smem {smem}>{t.smem_bytes}")

        # Halo overhead: the 2·m·halo halo rows are recomputed per block;
        # under dx > 1 the 2·m·halo_x guard columns add the analogous
        # column trapezoid (DESIGN.md §15). The batch axis multiplies
        # sites (b independent grids advance per launch), leaving the
        # useful fraction unchanged.
        if clusters is None:
            colf = shard_w / (shard_w + 2 * m * hx) if dx > 1 else 1.0
            useful = bh / (bh + 2 * m * w.halo) * colf
            flops = b * w.elems * w.flops_per_elem * m / useful
            hbm_passes = 1
            launches = 1
            exch_halo = m * w.halo  # halo rows exchanged per m-step block
            exch_halo_x = m * hx  # guard columns exchanged per block
        else:
            m_c = m if len(clusters) == 1 else 1
            # Per-cluster recompute at the cluster's composed halo; the
            # cluster fuses m_c steps (m when fused, 1 per launch when
            # pipelined — a program step is one pass through the chain).
            launches = m // m_c  # cluster launches per m-step block
            flops = sum(
                b * w.elems * c["flops"] * launches * m_c
                / (bh / (bh + 2 * m_c * c["halo"]))
                / ((shard_w / (shard_w + 2 * m_c * c["halo"]))
                   if dx > 1 else 1.0)
                for c in clusters
            )
            useful = (b * w.elems * w.flops_per_elem * m) / flops
            # Every cut edge costs a full-grid HBM write + read per
            # program step: k clusters = m·k grid passes per m-step
            # block vs the fused path's single pass.
            hbm_passes = 1 if len(clusters) == 1 else m * len(clusters)
            exch_halo = sum(
                launches * m_c * c["halo"] for c in clusters
            )
            exch_halo_x = exch_halo  # stage halos are symmetric in x/y
            launches = launches * len(clusters)  # total per m-step block
        t_compute = flops / (d * t.vpu_f32_tflops * 1e12)
        t_memory = (
            hbm_passes * b * w.elems * bytes_per_elem
            / (d * t.hbm_gbs * 1e9)
        )
        # Cross-chip halo exchange: the row exchange moves 2·m·halo rows
        # per neighbor pair at the per-shard *width*, the column exchange
        # 2·m·halo_x columns at the per-shard *height* (per cluster
        # launch for pipelined programs) — two separately priced volumes,
        # so tall and wide grids prefer different mesh shapes.
        grid_h = w.elems // grid_w
        halo_bytes = 0.0
        if dy > 1:
            halo_bytes += 2 * 2 * exch_halo * shard_w * w.words_in * 4
        if dx > 1:
            halo_bytes += 2 * 2 * exch_halo_x * (grid_h // dy) * w.words_in * 4
        t_coll = halo_bytes / (t.ici_gbs_per_link * 1e9)

        # Dispatch latency for the launches beyond the first: 0 for
        # every single-launch block (legacy predictions unchanged),
        # (m·k - 1)·overhead for a pipelined k-cluster program — the
        # term that separates fused from pipelined once calibration has
        # made HBM cheap (DESIGN.md §14).
        t_launch = (launches - 1) * t.launch_overhead_s
        step_time = max(t_compute, t_memory, t_coll) + t_launch
        useful_flops = b * w.elems * w.flops_per_elem * m
        sustained = useful_flops / step_time / 1e9 if step_time > 0 else 0.0
        peak = d * t.vpu_f32_tflops * 1e3  # GFlop/s
        # One spelling for the binding resource, shared verbatim with
        # evaluate_batch's data["bound"] (asserted in tests/test_explorer).
        bound = (
            "compute-bound"
            if t_compute >= max(t_memory, t_coll)
            else ("memory-bound" if t_memory >= t_coll else "collective-bound")
        )
        pt.limits.append(bound)
        pt.peak_gflops = peak
        pt.sustained_gflops = sustained
        pt.utilization = sustained / peak if peak else 0.0
        pt.power_w = d * (
            t.chip_idle_w + (t.chip_peak_w - t.chip_idle_w) * pt.utilization
        )
        pt.perf_per_watt = sustained / pt.power_w if pt.power_w > 0 else 0.0
        pt.detail = {
            "vmem_bytes": vmem,
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "halo_useful_fraction": useful,
            "arithmetic_intensity": m * w.flops_per_elem / bytes_per_elem,
            "block_rows": bh,
            "vmem_frac": vmem / t.vmem_bytes,
            "smem_bytes": smem,
            "d": d,
            "dx": dx,
            "dy": dy,
            "double_buffer": bool(double_buffer),
            "b": b,
            "fusion": fusion,
            "hbm_passes": hbm_passes,
            "launches": launches,
            "t_launch_s": t_launch,
        }
        return pt

    def evaluate_batch(
        self,
        w: StreamWorkload,
        bh,
        m,
        d=1,
        double_buffer: bool = True,
        b=1,
        fusion: str = "",
        dx=1,
    ) -> dict[str, np.ndarray]:
        """Vectorized :meth:`evaluate` over ``bh``/``m``/``d``/``b``/``dx``
        arrays.

        Coordinates broadcast against each other; returns a dict of arrays
        in the broadcast shape, numerically identical to the scalar path.
        ``d`` is the device axis (the *total* chip count); the returned
        dict carries it under both ``"n"`` and ``"d"``. ``dx`` is the
        column axis of the ``(dy, dx)`` mesh (DESIGN.md §15), returned
        under ``"dx"`` with the derived ``"dy"`` alongside. ``b`` is the
        batch axis (docs/pipeline.md §serve), returned under ``"b"``.
        ``fusion`` is one partition spec for the whole lattice slab (the
        sweep loops over specs and concatenates, docs/pipeline.md
        §program); it is returned under ``"fusion"`` as an object column.
        """
        t = self.target
        bh = np.asarray(bh, dtype=np.int64)
        m = np.asarray(m, dtype=np.int64)
        chips = np.asarray(d, dtype=np.int64)
        batch = np.maximum(np.asarray(b, dtype=np.int64), 1)
        dxa = np.maximum(np.asarray(dx, dtype=np.int64), 1)
        bh, m, chips, batch, dxa = np.broadcast_arrays(
            bh, m, chips, batch, dxa
        )
        grid_w = w.grid_w or int(math.sqrt(w.elems))
        bytes_per_elem = 4 * (w.words_in + w.words_out)
        clusters = w.fusion_clusters(fusion) if w.stages else None
        fusion = (
            "+".join(str(s) for s in parse_fusion(fusion, len(w.stages)))
            if w.stages else ""
        )

        # Mesh factorization (DESIGN.md §15) — same derivations as the
        # scalar path, elementwise.
        hx = w.stencil_halo_x
        dya = np.maximum(chips // dxa, 1)
        shard_w = np.maximum(grid_w // dxa, 1)

        guard = np.where(dxa > 1, hx, 0)
        if clusters is None:
            vmem = stripe_vmem_bytes(
                bh, m, shard_w, w.words_in, halo=w.halo,
                double_buffer=double_buffer, b=batch, halo_x=guard,
            )
        else:
            m_c = np.where(len(clusters) == 1, m, 1)
            vmem = np.maximum.reduce([
                cluster_vmem_bytes(
                    bh, m_c, shard_w, c["words"], c["halos"],
                    double_buffer, b=batch,
                )
                for c in clusters
            ])
        feasible = vmem <= t.vmem_bytes
        # the smallest Hopper tile must fit a block (scalar path's limit)
        smem = w.tile_smem_bytes(bh, m)
        feasible = feasible & (smem <= t.smem_bytes)
        # the mesh must factor the device count (scalar path's hard limit)
        feasible = feasible & (chips % dxa == 0)
        if w.grid_w:
            # y-sharding needs dy equal shards, x-sharding dx equal
            # shards (same checks as the scalar path and the
            # repro_torch.core.distribute kernel's hard errors).
            grid_h = w.elems // w.grid_w
            feasible = feasible & ((dya == 1) | (grid_h % dya == 0))
            feasible = feasible & ((dxa == 1) | (grid_w % dxa == 0))
            # blocks taller than the shard cannot be clamped into the
            # launch geometry (scalar path's limit)
            shard_h = np.maximum(grid_h // dya, 1)
            feasible = feasible & ((dya == 1) | (bh <= shard_h))
        else:
            # no known width: column sharding has no executable geometry
            feasible = feasible & (dxa == 1)
        # batched + sharded has no executable geometry (scalar path's limit)
        feasible = feasible & ((batch == 1) | (chips == 1))

        if clusters is None:
            colf = np.where(
                dxa > 1, shard_w / (shard_w + 2 * m * hx), 1.0
            )
            useful = bh / (bh + 2 * m * w.halo) * colf
            flops = batch * w.elems * w.flops_per_elem * m / useful
            hbm_passes = np.ones_like(m, dtype=np.float64)
            launches = np.ones_like(m, dtype=np.float64)
            exch_halo = (m * w.halo).astype(np.float64)
            exch_halo_x = (m * hx).astype(np.float64)
        else:
            m_c = np.where(len(clusters) == 1, m, 1)
            launches = m // m_c
            flops = sum(
                batch * w.elems * c["flops"] * launches * m_c
                / (bh / (bh + 2 * m_c * c["halo"]))
                / np.where(
                    dxa > 1,
                    shard_w / (shard_w + 2 * m_c * c["halo"]),
                    1.0,
                )
                for c in clusters
            )
            useful = (batch * w.elems * w.flops_per_elem * m) / flops
            hbm_passes = np.where(
                len(clusters) == 1, 1.0, (m * len(clusters)).astype(np.float64)
            )
            exch_halo = sum(
                (launches * m_c * c["halo"]).astype(np.float64)
                for c in clusters
            )
            exch_halo_x = exch_halo  # stage halos are symmetric in x/y
            launches = (launches * len(clusters)).astype(np.float64)
        t_compute = flops / (chips * t.vpu_f32_tflops * 1e12)
        t_memory = (
            hbm_passes * batch * w.elems * bytes_per_elem
            / (chips * t.hbm_gbs * 1e9)
        )
        # Two exchange volumes (DESIGN.md §15): rows at shard width over
        # dy, guard columns at shard height over dx.
        shard_h = (w.elems // grid_w) // dya
        halo_bytes = np.where(
            dya > 1, 2.0 * 2 * exch_halo * shard_w * w.words_in * 4, 0.0
        ) + np.where(
            dxa > 1, 2.0 * 2 * exch_halo_x * shard_h * w.words_in * 4, 0.0
        )
        t_coll = halo_bytes / (t.ici_gbs_per_link * 1e9)

        # Same launch-dispatch term as the scalar path (0 when
        # launches == 1, so legacy slabs are numerically unchanged).
        step_time = (
            np.maximum(np.maximum(t_compute, t_memory), t_coll)
            + (launches - 1) * t.launch_overhead_s
        )
        useful_flops = batch * w.elems * w.flops_per_elem * m
        sustained = np.where(step_time > 0, useful_flops / step_time / 1e9, 0.0)
        peak = chips * t.vpu_f32_tflops * 1e3
        util = np.where(peak > 0, sustained / peak, 0.0)
        power = chips * (t.chip_idle_w + (t.chip_peak_w - t.chip_idle_w) * util)
        ppw = np.where(power > 0, sustained / power, 0.0)
        bound = np.where(
            t_compute >= np.maximum(t_memory, t_coll),
            "compute-bound",
            np.where(t_memory >= t_coll, "memory-bound", "collective-bound"),
        )
        return {
            "n": chips,
            "d": chips,
            "dx": dxa,
            "dy": dya,
            "m": m,
            "b": batch,
            "block_rows": bh,
            "feasible": feasible,
            "peak_gflops": peak,
            "utilization": util,
            "sustained_gflops": sustained,
            "power_w": power,
            "perf_per_watt": ppw,
            "vmem_bytes": vmem,
            "smem_bytes": smem,
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "halo_useful_fraction": useful,
            "arithmetic_intensity": m * w.flops_per_elem / bytes_per_elem,
            "bound": bound,
            "resource_frac": vmem / t.vmem_bytes,
            "fusion": np.full(bh.shape, fusion, dtype=object),
            "launches": launches,
        }

    def explore(
        self,
        w: StreamWorkload,
        bh_values: Iterable[int] = (8, 16, 32, 64, 128, 256),
        m_values: Iterable[int] = (1, 2, 4, 8, 16, 32),
        d: int = 1,
    ) -> list[DesignPoint]:
        pts = [
            self.evaluate(w, bh, m, d)
            for bh in bh_values
            for m in m_values
        ]
        return sorted(
            pts,
            key=lambda p: (p.feasible, p.sustained_gflops),
            reverse=True,
        )


def render_table(points: Sequence[DesignPoint]) -> str:
    """Markdown Table-III-style rendering of design points.

    GPU points (which carry ``block_rows`` in their detail) get an extra
    ``bh`` column so same-(n, m) blockings stay distinguishable.
    """
    with_bh = any("block_rows" in p.detail for p in points)
    bh_head, bh_rule = ("| bh ", "|----") if with_bh else ("", "")
    head = (
        f"| n | m {bh_head}| feasible | peak GF/s | util | sustained GF/s "
        "| W | GF/sW | limits |\n"
        f"|---|---{bh_rule}|----------|-----------|------|----------------"
        "|---|-------|--------|"
    )
    rows = []
    for p in points:
        bh_cell = f"| {p.detail.get('block_rows', '-')} " if with_bh else ""
        rows.append(
            f"| {p.n} | {p.m} {bh_cell}| {'y' if p.feasible else 'N'} | "
            f"{p.peak_gflops:8.1f} | {p.utilization:.3f} | "
            f"{p.sustained_gflops:10.1f} | {p.power_w:5.1f} | "
            f"{p.perf_per_watt:.3f} | {';'.join(p.limits)} |"
        )
    return "\n".join([head] + rows)
