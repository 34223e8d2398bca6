"""Design-space explorer: batched lattice sweeps -> Pareto frontier -> run.

The port of the JAX package's ``core/explorer.py`` (docs/port.md §dse);
the executable form of the paper's §III workflow (DESIGN.md §5,
docs/pipeline.md §execute). Where :mod:`repro_torch.core.dse` models one
(n, m) point at a time, the explorer

1. enumerates the full coordinate lattice for a compiled SPD core —
   (n, m) for the FPGA target, (block_h, m, d) for the GPU target, where
   d is the device axis (cards the grid shards across) — and evaluates
   every point in one batched NumPy call
   (:meth:`FPGAModel.evaluate_batch` / :meth:`GPUModel.evaluate_batch`);
2. extracts the Pareto frontier over (throughput, perf/W, resource use)
   with a vectorized dominance check (:func:`pareto_mask`);
3. for the GPU target, *searches* the lattice with measurement in the
   loop: :meth:`Explorer.search` hands the sweep to a pluggable
   :class:`~repro_torch.core.search.SearchStrategy`
   (docs/pipeline.md §search) driving the one legalize→run→time engine,
   :class:`~repro_torch.core.search.SearchRunner` — any generated SPD
   core runs through it, on one card or sharded across ``d`` devices
   with halo exchange (``repro_torch.core.distribute``) — under an
   optional hard measurement budget. :meth:`Explorer.execute_frontier`
   is the top-k frontier walk, a thin facade over
   ``search(strategy=ExhaustiveSearch(k, frontier_only=True))``. Timing,
   backend calibration and the persistent measurement cache come from
   :mod:`repro_torch.core.measure` (docs/pipeline.md §measure).

The paper's "find the best among them" result — (n, m) = (1, 4) on the
Stratix V — falls out of ``Explorer.sweep_fpga(...).best()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .dse import (
    DesignPoint,
    FPGAModel,
    StreamWorkload,
    GPUModel,
    render_table,
)
from .search import (
    ExecutedPoint,
    ExhaustiveSearch,
    SearchResult,
    SearchRunner,
    get_strategy,
    kernel_run_factory,
)

__all__ = [
    "ExecutedPoint",
    "Explorer",
    "SearchResult",
    "Sweep",
    "pareto_mask",
    "render_executed",
]


# --------------------------------------------------------------------------
# Pareto frontier extraction
# --------------------------------------------------------------------------


def pareto_mask(objectives, maximize: Sequence[bool] | None = None) -> np.ndarray:
    """Boolean mask of non-dominated rows of an (P, K) objective matrix.

    A row i is dominated when some row j is >= on every column and > on at
    least one (after flipping minimized columns). Fully vectorized: one
    (P, P, K) broadcast, no per-point Python loop — fine for the few
    thousand points a lattice sweep produces.

    Rows with any non-finite objective are excluded up front and never
    returned: NaN compares False against everything, which would have
    made such rows "never dominated" and polluted the frontier.
    """
    X = np.asarray(objectives, dtype=float)
    if X.ndim == 1:
        X = X[:, None]
    if maximize is not None:
        sign = np.where(np.asarray(maximize, dtype=bool), 1.0, -1.0)
        X = X * sign
    mask = np.zeros(X.shape[0], dtype=bool)
    idx = np.flatnonzero(np.isfinite(X).all(axis=1))
    if idx.size == 0:
        return mask
    F = X[idx]
    ge = (F[None, :, :] >= F[:, None, :]).all(axis=-1)  # ge[i, j]: j >= i
    gt = (F[None, :, :] > F[:, None, :]).any(axis=-1)  # gt[i, j]: j > i somewhere
    dominated = (ge & gt).any(axis=1)
    mask[idx] = ~dominated
    return mask


# --------------------------------------------------------------------------
# Sweep result
# --------------------------------------------------------------------------

#: frontier objectives: maximize throughput and perf/W, minimize resources.
DEFAULT_OBJECTIVES = ("sustained_gflops", "perf_per_watt", "resource_frac")
DEFAULT_MAXIMIZE = (True, True, False)


@dataclass
class Sweep:
    """One batched lattice evaluation: coordinate + metric arrays.

    ``data`` holds one NumPy array per metric, all flattened to the same
    length; ``point(i)`` re-materializes index i as a full scalar
    :class:`DesignPoint` (via the scalar model path, so limits/detail are
    exactly what ``evaluate`` would have produced).
    """

    target: str  # 'fpga' | 'gpu'
    workload: StreamWorkload
    model: object
    data: dict[str, np.ndarray]
    census: dict | None = None
    coord_names: tuple = field(default=())
    scalar_kwargs: dict = field(default_factory=dict)  # extra evaluate() args

    def __post_init__(self):
        if not self.coord_names:
            self.coord_names = (
                ("n", "m") if self.target == "fpga" else ("block_rows", "m", "n")
            )

    def __len__(self) -> int:
        return int(self.data["sustained_gflops"].size)

    @property
    def feasible(self) -> np.ndarray:
        return self.data["feasible"]

    def metrics(self, names: Sequence[str]) -> np.ndarray:
        """Column-stack the named metric arrays into a (P, K) matrix."""
        return np.column_stack([np.asarray(self.data[n], float) for n in names])

    # ---- frontier ----------------------------------------------------------

    def pareto_mask(
        self,
        objectives: Sequence[str] = DEFAULT_OBJECTIVES,
        maximize: Sequence[bool] = DEFAULT_MAXIMIZE,
        feasible_only: bool = True,
    ) -> np.ndarray:
        """Non-dominated mask over the sweep (infeasible points excluded)."""
        mask = np.zeros(len(self), dtype=bool)
        pool = self.feasible if feasible_only else np.ones(len(self), bool)
        idx = np.flatnonzero(pool)
        if idx.size == 0:
            return mask
        X = self.metrics(objectives)[idx]
        mask[idx] = pareto_mask(X, maximize)
        return mask

    def frontier(
        self,
        objectives: Sequence[str] = DEFAULT_OBJECTIVES,
        maximize: Sequence[bool] = DEFAULT_MAXIMIZE,
        sort_by: str = "sustained_gflops",
    ) -> list[DesignPoint]:
        """Pareto-optimal points, materialized and sorted best-first."""
        idx = np.flatnonzero(self.pareto_mask(objectives, maximize))
        order = np.argsort(-np.asarray(self.data[sort_by], float)[idx])
        return [self.point(int(i)) for i in idx[order]]

    def best(self, key: str = "perf_per_watt") -> DesignPoint:
        """The single best feasible point by ``key`` (paper: argmax GF/sW)."""
        idx = np.flatnonzero(self.feasible)
        if idx.size == 0:
            raise ValueError(f"sweep of {len(self)} points has no feasible point")
        vals = np.asarray(self.data[key], float)[idx]
        return self.point(int(idx[int(np.argmax(vals))]))

    def top(self, k: int, key: str = "sustained_gflops") -> list[DesignPoint]:
        """Top-k feasible points by ``key`` (no dominance filtering)."""
        idx = np.flatnonzero(self.feasible)
        vals = np.asarray(self.data[key], float)[idx]
        order = np.argsort(-vals)[:k]
        return [self.point(int(i)) for i in idx[order]]

    # ---- materialization ---------------------------------------------------

    def point(self, i: int) -> DesignPoint:
        """Re-evaluate lattice index ``i`` through the scalar model path."""
        if self.target == "fpga":
            return self.model.evaluate(
                self.workload,
                int(self.data["n"][i]),
                int(self.data["m"][i]),
                self.census,
                **self.scalar_kwargs,
            )
        kwargs = dict(self.scalar_kwargs)
        if "b" in self.data:  # batch-axis sweeps (docs/pipeline.md §serve)
            kwargs["b"] = int(self.data["b"][i])
        if "fusion" in self.data:  # program sweeps (docs/pipeline.md §program)
            kwargs["fusion"] = str(self.data["fusion"][i])
        if "dx" in self.data:  # mesh-shape sweeps (DESIGN.md §15)
            kwargs["dx"] = int(self.data["dx"][i])
        return self.model.evaluate(
            self.workload,
            int(self.data["block_rows"][i]),
            int(self.data["m"][i]),
            d=int(self.data["n"][i]),
            **kwargs,
        )

    def table(self, k: int | None = None, frontier_only: bool = False) -> str:
        if frontier_only:
            pts = self.frontier()[:k] if k else self.frontier()
        else:
            order = np.argsort(-np.asarray(self.data["sustained_gflops"], float))
            pts = [self.point(int(i)) for i in (order[:k] if k else order)]
        return render_table(pts)


# --------------------------------------------------------------------------
# Explorer
# --------------------------------------------------------------------------


def _as_workload(source, elems: int | None, grid_w: int) -> StreamWorkload:
    from .compiler import CompiledCore

    if isinstance(source, StreamWorkload):
        return source
    if elems is None:
        raise ValueError("elems is required when exploring from a core/report")
    if isinstance(source, CompiledCore):  # with its kernel's Hopper tile
        return source.stream_workload(elems, grid_w)
    report = getattr(source, "hardware_report", source)
    return StreamWorkload.from_report(report, elems=elems, grid_w=grid_w)


class Explorer:
    """Sweeps a compiled SPD core's design space under both target models.

    ``source`` may be a :class:`StreamWorkload`, a
    :class:`~repro_torch.core.compiler.HardwareReport`, or anything with a
    ``hardware_report`` attribute (``CompiledCore``, ``LBMSimulation``);
    for the latter two, ``elems`` (stream length) must be given. When the
    source is (or ``core`` names) a compiled core, GPU lattice points
    can be executed through its generated stream kernel with
    :meth:`search` / :meth:`execute_frontier`
    (docs/pipeline.md §execute, §search). A ``CompiledCore`` source
    brings its kernel's Hopper tile into the workload
    (``CompiledCore.stream_workload``), which the ``smem`` rule prices.
    """

    def __init__(
        self,
        source,
        elems: int | None = None,
        grid_w: int = 0,
        fpga: FPGAModel | None = None,
        gpu: GPUModel | None = None,
        census: dict | None = None,
        core=None,
    ):
        from .compiler import CompiledCore

        self.workload = _as_workload(source, elems, grid_w)
        self.fpga = fpga or FPGAModel()
        self.gpu = gpu or GPUModel()
        report = getattr(source, "hardware_report", source)
        self.census = census or getattr(report, "census", None)
        self.core = core if core is not None else (
            source if isinstance(source, CompiledCore) else None
        )

    # ---- lattice sweeps ----------------------------------------------------

    def sweep_fpga(
        self,
        n_values: Sequence[int] = (1, 2, 4, 8),
        m_values: Sequence[int] = (1, 2, 4, 8),
        overlapped_passes: bool = True,
    ) -> Sweep:
        """Evaluate the full (n, m) lattice in one batched call."""
        n, m = np.meshgrid(
            np.asarray(n_values, np.int64), np.asarray(m_values, np.int64),
            indexing="ij",
        )
        data = self.fpga.evaluate_batch(
            self.workload, n.ravel(), m.ravel(), self.census,
            overlapped_passes=overlapped_passes,
        )
        return Sweep(
            "fpga", self.workload, self.fpga, data, self.census,
            scalar_kwargs={"overlapped_passes": overlapped_passes},
        )

    def sweep_gpu(
        self,
        bh_values: Sequence[int] = (8, 16, 32, 64, 128, 256),
        m_values: Sequence[int] = (1, 2, 4, 8, 16, 32),
        d_values: Sequence[int] = (1, 2, 4),
        double_buffer: bool = True,
        b_values: Sequence[int] = (1,),
        fusion_values: Sequence[str] = ("",),
        dx_values: Sequence[int] = (1,),
    ) -> Sweep:
        """Evaluate the (block_h, m, d[, b][, fusion][, dx]) lattice batched.

        ``d`` is the device axis — the *total* card count the grid is
        sharded across (docs/pipeline.md §distribute). ``dx_values``
        adds the mesh-shape axis (DESIGN.md §15): each point's ``d``
        factors as a ``(dy, dx) = (d // dx, dx)`` mesh, with
        non-factorizing combinations marked infeasible by the model —
        so passing the full ``device_axis_values(...)`` list for both
        ``d_values`` and ``dx_values`` enumerates exactly the legal
        factorizations. The ``(1,)`` default keeps classic row-ring
        sweeps unchanged. ``double_buffer``
        threads through to both the batched evaluation and the scalar
        ``Sweep.point`` re-materialization. ``b_values`` adds the batch
        axis — independent simulations stacked into one launch
        (docs/pipeline.md §serve); the default keeps the classic 3-D
        lattice. ``fusion_values`` adds the program fusion-partition
        axis (docs/pipeline.md §program): one sub-lattice per spec,
        concatenated, with the spec carried per point in
        ``data["fusion"]`` — only meaningful when the workload has
        program ``stages``; the ``("",)`` default keeps single-core
        sweeps unchanged.
        """
        bh, m, d, b, dxg = np.meshgrid(
            np.asarray(bh_values, np.int64),
            np.asarray(m_values, np.int64),
            np.asarray(d_values, np.int64),
            np.asarray(b_values, np.int64),
            np.asarray(dx_values, np.int64),
            indexing="ij",
        )
        chunks = [
            self.gpu.evaluate_batch(
                self.workload, bh.ravel(), m.ravel(), d=d.ravel(),
                double_buffer=double_buffer, b=b.ravel(),
                fusion=str(spec), dx=dxg.ravel(),
            )
            for spec in fusion_values
        ]
        if len(chunks) == 1:
            data = chunks[0]
        else:
            data = {
                k: np.concatenate([c[k] for c in chunks])
                for k in chunks[0]
            }
        return Sweep(
            "gpu", self.workload, self.gpu, data,
            scalar_kwargs={"double_buffer": double_buffer},
        )

    def sweep(self, target: str, **kw) -> Sweep:
        if target == "fpga":
            return self.sweep_fpga(**kw)
        if target == "gpu":
            return self.sweep_gpu(**kw)
        raise ValueError(f"unknown target {target!r} (want 'fpga' or 'gpu')")

    # ---- model -> measurement (the pluggable search subsystem) -------------

    def search(
        self,
        sweep: "Sweep",
        state=None,
        regs: Sequence = (),
        *,
        strategy="exhaustive",
        budget: int | None = None,
        core=None,
        steps: int | None = None,
        device=None,
        reps: int = 3,
        warmup: int = 1,
        calibrate: bool = True,
        cache=None,
        cache_tag: str | None = None,
        run_factory=None,
        grid_shape: tuple[int, int] | None = None,
        max_devices: int | None = None,
        timer=None,
        study=None,
        study_dir: str | None = None,
    ) -> SearchResult:
        """Search the GPU lattice with measurement in the loop.

        The facade over :mod:`repro_torch.core.search`
        (docs/pipeline.md §search, docs/port.md §dse): ``strategy`` — a
        name (``"exhaustive"`` / ``"refine"`` / ``"halving"`` /
        ``"tpe"``), class, or
        :class:`~repro_torch.core.search.SearchStrategy` instance —
        decides which (n, m, d, block_h) candidates to spend measurements
        on (the default, ``"exhaustive"``, measures the model's Pareto
        frontier, not the whole lattice); every measurement goes through
        one :class:`~repro_torch.core.search.SearchRunner`: legalized by
        the shared :func:`repro_torch.core.legalize.resolve_run_plan`,
        executed, and timed with the honest harness
        :func:`repro_torch.core.measure.time_run` — ``warmup`` un-timed
        calls (a kernel's first build lands there), ``reps`` measured
        calls each synchronized, median wall time. Distinct lattice
        points that legalize to the same concrete plan are timed once per
        search; plans the back end cannot launch are declined and
        counted (``SearchResult.declined``).

        ``budget`` is a **hard cap on live measurements** for this
        invocation. Cache hits and in-run dedupe hits are free —
        strategies compose across invocations through the shared
        :class:`~repro_torch.core.measure.MeasurementCache`
        (``cache=True``/path/instance), whose keys include the core's DFG
        fingerprint; custom ``run_factory`` back ends must pass
        ``cache_tag`` to identify the kernel (else caching is skipped).

        With ``calibrate=True`` (the default) the platform is probed
        through the same execution path
        (:func:`repro_torch.core.measure.calibrate_execution`, one anchor
        per device-axis value; probes are not charged against
        ``budget``) and each point's ``rel_error`` is reported against
        the *calibrated* prediction. The raw uncalibrated diff survives
        as ``rel_error_model``.

        Default back end: ``core`` (or the compiled core this explorer
        was built from) lowers to a
        :class:`~repro_torch.core.codegen.StreamKernel`; ``state`` is the
        stacked ``(P, H, W)`` grid, whose device picks the path (the
        generated kernel on a card, its plain version on the CPU), and
        ``regs`` the core's ``Append_Reg`` values. Points with ``d > 1``
        run through :class:`repro_torch.core.distribute.ShardedStreamKernel`;
        points needing more devices than ``max_devices`` (default: the
        card count, 1 on the CPU) are skipped. Custom back ends plug in
        via ``run_factory(nsteps, m, block_h, d, double_buffer) ->
        nullary-callable | None`` plus the concrete ``grid_shape=(h, w)``
        and the ``device`` they run on (default ``"cuda"``). ``timer``
        injects the timing primitive (tests drive whole strategies with
        a deterministic fake).

        ``study`` attaches a durable :class:`~repro_torch.core.search.Study`
        journal (docs/pipeline.md §study): a name (resumed/created under
        ``study_dir``) or an instance. Its completed trials for this
        exact measurement context (core fingerprint, grid, backend,
        interpret, warmup) are replayed into the runner's plan-dedupe
        table — a resumed search re-measures **zero** of them — and every
        new measurement is journaled back.
        """
        from repro_torch.interop import resolve_device

        from . import measure

        if sweep.target != "gpu":
            raise ValueError(
                "search needs a GPU sweep (the FPGA target is a model "
                "only; there is no Stratix V attached)"
            )
        halo = sweep.workload.halo
        fingerprint = cache_tag
        if run_factory is None:
            from .codegen import StreamKernel

            core = core if core is not None else self.core
            if core is None:
                raise ValueError(
                    "Explorer.search needs a compiled core: build the "
                    "explorer from a CompiledCore or pass core=..."
                )
            kern = (
                core if isinstance(core, StreamKernel)
                else core.stream_kernel(device=state.device)
            )
            words, h, w = state.shape
            halo, width = kern.halo, w
            device = state.device
            # The DFG fingerprint always wins on this path — a cache_tag
            # must never alias two structurally different cores onto one
            # cache key; tags are for run_factory back ends.
            fingerprint = measure.core_fingerprint(kern)
            run_factory = kernel_run_factory(kern, state, regs)
        else:
            if grid_shape is None:
                raise ValueError("run_factory needs grid_shape=(h, w)")
            h, w = grid_shape
            # The concrete stripe geometry, so this path gets the same
            # VMEM legalization the codegen path does.
            width, words = w, sweep.workload.words_in
            device = resolve_device("cuda" if device is None else device)

        strat = get_strategy(strategy)
        runner = SearchRunner(
            workload=sweep.workload,
            grid_shape=(h, w),
            run_factory=run_factory,
            model=sweep.model,
            scalar_kwargs=sweep.scalar_kwargs,
            fingerprint=fingerprint,
            halo=halo,
            width=width,
            words=words,
            steps=steps,
            device=device,
            reps=reps,
            warmup=warmup,
            calibrate=calibrate,
            cache=cache,
            budget=budget,
            timer=timer,
            max_devices=max_devices,
        )
        replayed = 0
        if study is not None:
            from .search.study import Study

            if isinstance(study, str):
                study = Study.resume(study, study_dir)
            if runner.study_fingerprint() is None:
                import warnings

                warnings.warn(
                    "Explorer.search: study disabled — this back end has "
                    "no core fingerprint, so its trials cannot be "
                    "identified across processes; pass cache_tag= to "
                    "identify the kernel",
                    RuntimeWarning,
                    stacklevel=2,
                )
                study = None
            else:
                replayed = study.replay_into(runner)
                runner.study = study
                runner.study_meta = {
                    "strategy": strat.name,
                    "seed": getattr(strat, "seed", None),
                }
        executed = strat.search(sweep, runner)
        return SearchResult(
            strategy=strat.name,
            executed=executed,
            budget=runner.budget,
            budget_spent=runner.budget_spent,
            measurements=runner.measurements(),
            skipped_devices=runner.skipped_devices,
            skipped_illegal=runner.skipped_illegal,
            declined=runner.declined,
            study=None if study is None else study.name,
            replayed=replayed,
        )

    def execute_frontier(
        self,
        sweep: "Sweep",
        state=None,
        regs: Sequence = (),
        core=None,
        k: int = 3,
        steps: int | None = None,
        device=None,
        reps: int = 3,
        *,
        warmup: int = 1,
        calibrate: bool = True,
        cache=None,
        cache_tag: str | None = None,
        run_factory=None,
        grid_shape: tuple[int, int] | None = None,
        max_devices: int | None = None,
    ) -> list["ExecutedPoint"]:
        """Run the top-k *runnable* GPU frontier points and time them.

        A thin facade over :meth:`search` with
        ``strategy=ExhaustiveSearch(k=k, frontier_only=True)``
        (docs/pipeline.md §execute, §search): walk the Pareto frontier
        best-first until ``k`` points have actually executed, skipping
        points the platform has too few devices for, that have no legal
        plan, or that the back end declines. All measurement semantics
        are the runner's; see :meth:`search`.
        """
        result = self.search(
            sweep, state, regs,
            strategy=ExhaustiveSearch(k=k, frontier_only=True),
            core=core, steps=steps, device=device, reps=reps,
            warmup=warmup, calibrate=calibrate, cache=cache,
            cache_tag=cache_tag, run_factory=run_factory,
            grid_shape=grid_shape, max_devices=max_devices,
        )
        skipped = (result.skipped_devices + result.skipped_illegal
                   + result.declined)
        if skipped and len(result.executed) < k:
            import warnings

            reasons = []
            if result.skipped_devices:
                reasons.append(
                    f"{result.skipped_devices} needing more devices than "
                    "the platform has (sweep with d_values capped at the "
                    "card count)"
                )
            if result.skipped_illegal:
                reasons.append(
                    f"{result.skipped_illegal} with no legal run plan on "
                    "this grid (VMEM/halo constraints — see "
                    "repro_torch.core.legalize)"
                )
            if result.declined:
                reasons.append(
                    f"{result.declined} the back end could not launch "
                    "(no tile fits shared memory, or a batch axis)"
                )
            warnings.warn(
                f"execute_frontier skipped {skipped} frontier point(s) — "
                + "; ".join(reasons)
                + f" — and executed only {len(result.executed)} of the "
                f"requested {k}.",
                RuntimeWarning,
                stacklevel=2,
            )
        return result.executed


def render_executed(points: Sequence[ExecutedPoint]) -> str:
    """Markdown table of predicted-vs-measured executions.

    ``calib GF/s`` is the prediction under measured platform constants
    (``-`` when calibration was off); ``rel err`` diffs against it when
    present (docs/pipeline.md §measure). ``src`` is ``cache`` when the
    wall time came from the measurement cache (or this search already
    timed the same plan). ``fuse`` is the program fusion partition
    (``-`` for single-core plans). ``mesh`` is the point's device mesh
    ``dy x dx`` (DESIGN.md §15). ``mode`` is ``gpu`` for the generated
    kernel on the card and ``plain`` for its plain torch version.
    """
    head = (
        "| block_h | m | d | mesh | db | fuse | steps | model GF/s "
        "| calib GF/s "
        "| measured GF/s | MLUPS | rel err | src | mode |\n"
        "|---------|---|---|------|----|------|-------|------------"
        "|------------"
        "|---------------|-------|---------|-----|------|"
    )
    rows = [
        f"| {e.block_h} | {e.m} | {e.d} | "
        f"{e.d // max(getattr(e, 'dx', 1) or 1, 1)}"
        f"x{getattr(e, 'dx', 1)} | "
        f"{'pp' if e.double_buffer else '1b'} | "
        f"{e.fusion or '-'} | {e.steps} | "
        f"{e.predicted_gflops:10.1f} | "
        + (f"{e.calibrated_gflops:10.4g}" if e.calibrated_gflops is not None
           else f"{'-':>10}")
        + f" | {e.measured_gflops:13.4g} | {e.measured_mlups:6.2f} | "
        f"{e.rel_error:+.3f} | {'cache' if e.cached else 'live'} | "
        f"{'plain' if e.interpret else 'gpu'} |"
        for e in points
    ]
    return "\n".join([head] + rows)
