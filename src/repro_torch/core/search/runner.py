"""The one model→measurement engine behind every search strategy.

The port of the JAX package's ``core/search/runner.py`` (docs/port.md
§dse). :class:`SearchRunner` is the plan-evaluation loop every
:class:`~repro_torch.core.search.strategies.SearchStrategy` — exhaustive
frontier walk, local refinement, successive halving, TPE — executes
through: the identical legalize→run→time path (docs/pipeline.md §search,
§execute, §measure). One call to :meth:`SearchRunner.measure` takes a
model :class:`~repro_torch.core.dse.DesignPoint` and

1. **legalizes** it through the shared
   :func:`repro_torch.core.legalize.resolve_run_plan` (per shard when the
   point's device axis ``d > 1``, always with the concrete stripe
   geometry so the VMEM clamp applies on every back end);
2. **dedupes** the concrete plan: distinct lattice points that legalize
   to the same ``(block_h, m, steps, d)`` are timed **once per search**
   — the second request is served from the in-run plan table even with
   the persistent cache off;
3. **times** it with the honest harness
   (:func:`repro_torch.core.measure.time_run`: warm-up separated, every
   rep synchronized, median wall) through the shared
   :class:`~repro_torch.core.measure.MeasurementCache` key space,
   charging the **measurement budget** only for live timings — cache and
   dedupe hits are free, which is what lets strategies compose across
   invocations;
4. **predicts** the executed geometry under the backend calibration
   (one probe per device-axis value, memoized per runner) so
   ``rel_error`` stays a model-fidelity signal.

A plan the back end cannot launch — a batch axis, which the port's
launches do not take yet, or a tile no thread block's shared memory holds
— is **declined** (the factory returns ``None``), counted in
``declined``, and never raises mid-search. When a live timing would
exceed the budget, :exc:`BudgetExhausted` is raised *before* the kernel
runs — the budget is a hard cap on measurements performed — and
strategies catch it to finalize with what they have. Calibration probes
are platform overhead shared by all candidates and are not charged
against the candidate budget; searches that must be exactly
budget-bounded run with ``calibrate=False``.

The timing primitive is injectable (``timer``): tests drive whole
strategies with a deterministic fake timer that maps a :class:`RunPlan`
to a synthetic wall time, so budget accounting and strategy decisions are
asserted without host-timing noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..dse import DesignPoint, StreamWorkload
from ..legalize import PLAN_FIELDS, RunPlan, resolve_run_plan

__all__ = [
    "BudgetExhausted",
    "EXECUTED_POINT_FIELDS",
    "ExecutedPoint",
    "PLAN_FIELDS",
    "RunPlan",
    "SearchRunner",
    "kernel_run_factory",
]


class BudgetExhausted(RuntimeError):
    """A live measurement was requested beyond the hard budget."""


def _point_b(point) -> int:
    """The batch-axis width a design point was modeled at (1 if none).

    Carried in ``DesignPoint.detail`` (set by ``GPUModel.evaluate``) so
    pre-batch points — older studies, FPGA points — legalize as b=1.
    """
    detail = getattr(point, "detail", None) or {}
    try:
        return max(1, int(detail.get("b", 1)))
    except (TypeError, ValueError):
        return 1


def _point_fusion(point) -> str:
    """The fusion partition a design point was modeled at ("" if none).

    Carried in ``DesignPoint.detail`` (set by ``GPUModel.evaluate`` when
    the workload has program stages — docs/pipeline.md §program) so
    single-core points keep the legacy empty spec.
    """
    detail = getattr(point, "detail", None) or {}
    return str(detail.get("fusion", "") or "")


def _point_dx(point) -> int:
    """The mesh column axis a design point was modeled at (1 if none).

    Carried in ``DesignPoint.detail`` (set by ``GPUModel.evaluate``,
    DESIGN.md §15) so pre-mesh points — older studies, FPGA points —
    legalize as the 1-D row ring.
    """
    detail = getattr(point, "detail", None) or {}
    try:
        return max(1, int(detail.get("dx", 1)))
    except (TypeError, ValueError):
        return 1


# RunPlan itself is single-sourced in ``repro_torch.core.legalize`` (one
# PLAN_FIELDS tuple shared by the legalizer, the runner, the study
# journal and the measurement-cache key space — docs/pipeline.md
# §search); it is re-exported here because the search package is where
# most call sites import it from.


#: The one executed-point record schema. Single source of truth for
#: every serialized form of a measurement: ``ExecutedPoint.as_dict``
#: (the CLI ``--json`` report) and the ``point``
#: field of a study trial record (docs/pipeline.md §study) all carry
#: exactly these keys — asserted in ``tests/test_torch_search.py``, so
#: downstream tooling cannot silently drift apart.
EXECUTED_POINT_FIELDS = (
    "block_h",
    "m",
    "d",
    "dx",
    "double_buffer",
    "b",
    "fusion",
    "steps",
    "wall_s",
    "measured_mlups",
    "measured_gflops",
    "predicted_gflops",
    "calibrated_gflops",
    "rel_error",
    "rel_error_model",
    "cached",
    "reps",
    "interpret",
)


@dataclass
class ExecutedPoint:
    """One design point run through the generated stream kernel."""

    point: DesignPoint
    block_h: int  # block actually used (clamped to divide the shard height)
    m: int
    d: int  # device axis: shards the grid ran across (1 = single device)
    steps: int
    wall_s: float  # median-of-reps wall time (repro_torch.core.measure.time_run)
    measured_mlups: float
    measured_gflops: float
    predicted_gflops: float  # uncalibrated model (the card's data-sheet peaks)
    rel_error: float  # (prediction - measured) / prediction, calibrated
    #                   prediction when calibration ran, raw model otherwise
    interpret: bool  # the plain torch version ran (a CPU state)
    # Prediction under measured platform constants (docs/pipeline.md
    # §measure); None when the runner measured with calibrate=False.
    calibrated_gflops: float | None = None
    rel_error_model: float = 0.0  # always vs the uncalibrated model
    cached: bool = False  # wall time came from the measurement cache (or
    #                       this search already timed the same plan)
    reps: int = 1
    double_buffer: bool = True  # streamed buffer protocol actually run
    b: int = 1  # batch axis: independent simulations stacked in the launch
    fusion: str = ""  # program fusion partition actually run ("" = single core)
    dx: int = 1  # mesh column axis: the d devices ran as a (d//dx, dx)
    #              mesh (DESIGN.md §15); 1 = the 1-D row ring

    def as_dict(self) -> dict:
        """JSON-ready record — the one serialization shared by the CLI's
        ``--json`` report and study trial records (one schema —
        :data:`EXECUTED_POINT_FIELDS` — extended in one place)."""
        return {
            "block_h": int(self.block_h),
            "m": int(self.m),
            "d": int(self.d),
            "dx": int(self.dx),
            "double_buffer": bool(self.double_buffer),
            "b": int(self.b),
            "fusion": str(self.fusion),
            "steps": int(self.steps),
            "wall_s": float(self.wall_s),
            "measured_mlups": float(self.measured_mlups),
            "measured_gflops": float(self.measured_gflops),
            "predicted_gflops": float(self.predicted_gflops),
            "calibrated_gflops": (
                None if self.calibrated_gflops is None
                else float(self.calibrated_gflops)
            ),
            "rel_error": float(self.rel_error),
            "rel_error_model": float(self.rel_error_model),
            "cached": bool(self.cached),
            "reps": int(self.reps),
            "interpret": bool(self.interpret),
        }


def kernel_run_factory(kern, state, regs: Sequence):
    """The default back end: a generated StreamKernel, sharded for d>1.

    Returns the ``run_factory(nsteps, m, block_h, d, double_buffer, b,
    dx)`` the runner calls. The state's device picks the path: a CUDA
    state launches the generated kernel, a CPU state runs its plain
    version. ``d > 1`` plans go through ``kern.sharded(d, dx=dx)`` —
    ``dx > 1`` runs the ``(d//dx, dx)`` device mesh (DESIGN.md §15) —
    over ``cuda:0 … cuda:d-1``, or the CPU d times for a CPU state (the
    counterpart of forced host devices); ``double_buffer`` selects the
    streamed launch's buffer protocol (docs/pipeline.md §stream). The
    factory declines (returns ``None``) a ``b > 1`` plan — the port's
    launches take no batch axis yet — and a plan with no column tile that
    fits a thread block's shared memory (docs/port.md §dse), so a search
    never raises mid-run on an unlaunchable plan.
    """
    width = int(state.shape[-1])
    sharded: dict[tuple[int, int], object] = {}

    def run_factory(nsteps: int, m: int, block_h: int, d: int,
                    double_buffer: bool = True, b: int = 1, dx: int = 1):
        if b > 1:
            return None  # no batched launch in the port yet
        try:
            kern.tile(width, block_h, m, double_buffer=double_buffer)
        except ValueError:
            return None  # no column tile fits shared memory
        if d == 1:
            return lambda: kern.run_blocked(
                state, regs, steps=nsteps, m=m, block_h=block_h,
                double_buffer=double_buffer,
            )
        if (d, dx) not in sharded:
            devices = [state.device] * d if state.device.type == "cpu" \
                else None
            sharded[(d, dx)] = kern.sharded(d, devices=devices, dx=dx)
        runner = sharded[(d, dx)]
        return lambda: runner.run_blocked(
            state, regs, steps=nsteps, m=m, block_h=block_h,
            double_buffer=double_buffer,
        )

    return run_factory


class SearchRunner:
    """Legalize → run → time → calibrate, with dedupe and a hard budget.

    Built once per search invocation (``Explorer.search`` /
    ``Explorer.execute_frontier``); strategies call :meth:`measure` per
    candidate and :meth:`point` to materialize neighborhood coordinates
    through the scalar model. All constructor arguments describe the
    fixed context of one search: the workload/grid being measured, the
    back end (``run_factory``) and the ``device`` it runs on, the
    measurement policy (reps/warmup/calibrate/cache), and the budget.
    ``interpret`` is derived: true exactly when ``device`` is the CPU,
    where the plain torch versions run, so a CPU record never serves a
    card run from the cache or a study. ``max_devices`` defaults to the
    card count for a CUDA device and 1 for the CPU.
    """

    def __init__(
        self,
        *,
        workload: StreamWorkload,
        grid_shape: tuple[int, int],
        run_factory: Callable,
        model=None,
        scalar_kwargs: dict | None = None,
        fingerprint: str | None = None,
        halo: int | None = None,
        width: int | None = None,
        words: int | None = None,
        stages: tuple | None = None,
        steps: int | None = None,
        device="cuda",
        reps: int = 3,
        warmup: int = 1,
        calibrate: bool = True,
        cache=None,
        budget: int | None = None,
        timer: Callable | None = None,
        max_devices: int | None = None,
    ):
        from .. import measure

        self.workload = workload
        self.h, self.w = int(grid_shape[0]), int(grid_shape[1])
        self.run_factory = run_factory
        self.model = model
        self.scalar_kwargs = dict(scalar_kwargs or {})
        self.fingerprint = fingerprint
        self.halo = workload.halo if halo is None else int(halo)
        # Column stencil reach for mesh (dx > 1) plans (DESIGN.md §15):
        # sizes the guard columns the legalizer prices per shard.
        self.halo_x = int(getattr(workload, "stencil_halo_x", self.halo))
        self.width = self.w if width is None else int(width)
        self.words = workload.words_in if words is None else int(words)
        # Per-stage (words, halo) geometry of a multi-core program: when
        # set, plans legalize through the fused-cluster accounting
        # (legalize.program_blocking_plan) at each point's fusion spec.
        self.stages = None if stages is None else tuple(stages)
        self.steps = steps
        self.device = torch.device(device)
        self.interpret = self.device.type == "cpu"
        self.reps = int(reps)
        self.warmup = int(warmup)
        self.calibrate = bool(calibrate)
        self.cache = measure.resolve_cache(cache)
        if self.cache is not None and fingerprint is None:
            import warnings

            warnings.warn(
                "SearchRunner: measurement cache disabled — this back end "
                "has no core fingerprint; pass cache_tag= to identify the "
                "kernel",
                RuntimeWarning,
                stacklevel=3,
            )
            self.cache = None
        self.budget = None if budget is None else int(budget)
        if self.budget is not None and self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
        self.timer = timer
        if max_devices is None:
            max_devices = (torch.cuda.device_count()
                           if self.device.type == "cuda" else 1)
        self.max_devices = int(max_devices)
        self.backend = measure.backend_descriptor(self.device)
        # ---- durable study attachment (docs/pipeline.md §study) -----------
        # Explorer.search wires these after replaying a resumed study's
        # completed trials into `_walls`: every measured point is then
        # journaled to the study as a trial, and replayed plans are free.
        self.study = None
        self.study_meta: dict = {}
        self.replayed = 0  # trials replayed into the dedupe table on resume
        # ---- per-search state ---------------------------------------------
        self.budget_spent = 0  # live timings charged against the budget
        self.skipped_devices = 0  # candidates needing more devices than we have
        self.skipped_illegal = 0  # candidates with no legal run plan
        self.declined = 0  # legal plans the back end cannot launch
        self._walls: dict[tuple, float] = {}  # plan.key() -> wall_s (dedupe)
        self._counts: dict[tuple, int] = {}  # plan.key() -> live timings
        self._cal_models: dict[int, object] = {}
        self._cal_mem: list[float] = []  # bandwidth probe, shared across d
        # ---- next-candidate prefetch (docs/pipeline.md §search) ------------
        # When a budget cut-off interrupts a strategy, the point it was
        # about to measure is recorded here; SearchStepper.step hands it
        # to prefetch() so its compile/warm-up runs on idle devices while
        # the caller ticks — timed reps never overlap the warm-up
        # (measure() joins any in-flight prefetch before timing).
        self.last_blocked = None  # the candidate BudgetExhausted cut off
        self.prefetched = 0  # warm-ups dispatched (observability)
        self._prefetch = None  # (plan.key(), Thread) of an in-flight warm-up

    # ---- model-side helpers ------------------------------------------------

    def point(self, block_h: int, m: int, d: int = 1,
              double_buffer: bool | None = None,
              fusion: str | None = None,
              dx: int | None = None) -> DesignPoint | None:
        """Materialize a lattice coordinate through the scalar model.

        Strategies use this to price neighborhood moves (LocalRefine's
        (block_h, m, d, double_buffer, dx) steps) before spending budget
        on them. ``double_buffer=None`` inherits the sweep's setting (the
        runner's ``scalar_kwargs``); ``dx=None`` keeps the model's 1-D
        ring default (DESIGN.md §15). ``None`` when the runner was built
        without a model (custom back ends that only replay frontier
        points).
        """
        if self.model is None:
            return None
        kwargs = dict(self.scalar_kwargs)
        if double_buffer is not None:
            kwargs["double_buffer"] = bool(double_buffer)
        if fusion is not None:
            kwargs["fusion"] = str(fusion)
        if dx is not None:
            kwargs["dx"] = int(dx)
        return self.model.evaluate(
            self.workload, int(block_h), int(m), d=int(d), **kwargs,
        )

    def plan_for(self, point, *, reps: int | None = None) -> RunPlan | None:
        """The concrete legalized plan a point would execute as.

        ``None`` when the point cannot run here (device-starved or no
        legal plan) — used by strategies to dedupe candidate pools
        before spending any budget.
        """
        d = max(1, int(point.n))
        if d > self.max_devices:
            return None
        b = _point_b(point)
        fusion = _point_fusion(point)
        dx = _point_dx(point)
        try:
            block_h, m, nsteps, double_buffer = resolve_run_plan(
                self.h, point, self.steps, halo=self.halo,
                width=self.width, words=self.words, d=d, b=b,
                stages=self.stages, fusion=fusion,
                dx=dx, halo_x=self.halo_x,
            )
        except ValueError:
            return None
        return RunPlan(block_h, m, nsteps, d,
                       self.reps if reps is None else int(reps),
                       double_buffer, b, fusion, dx)

    # ---- cache / study key space -------------------------------------------

    def study_fingerprint(self) -> str | None:
        """The fingerprint namespace this runner's walls live in.

        An injected timer produces synthetic walls: they live in their
        own key namespace so an honest run can never be served a
        fabricated timing — from the cache *or* from a replayed study
        trial (docs/pipeline.md §study) — and vice versa.
        """
        if self.fingerprint is None:
            return None
        if self.timer is None:
            return self.fingerprint
        return f"injected-timer:{self.fingerprint}"

    def cache_key(self, plan: RunPlan) -> str | None:
        """The MeasurementCache key this plan's timing is stored under.

        The same content key identifies the plan in study trial records,
        which is what lets :meth:`Study.replay_into` and the TPE
        warm-start recognize already-measured plans across processes.
        ``None`` when the back end has no core fingerprint.
        """
        from .. import measure

        fp = self.study_fingerprint()
        if fp is None:
            return None
        plan_key = (plan.block_h, plan.m, plan.steps, plan.d,
                    int(plan.double_buffer), plan.b)
        if plan.fusion:  # "" keeps pre-program cache keys byte-identical
            plan_key = plan_key + (plan.fusion,)
        if plan.dx > 1:  # 1 keeps pre-mesh cache keys byte-identical
            # always carry the fusion slot before dx so key tuples stay
            # unambiguous by length (6 legacy / 7 fusion / 8 fusion+dx)
            if not plan.fusion:
                plan_key = plan_key + (plan.fusion,)
            plan_key = plan_key + (plan.dx,)
        return measure.MeasurementCache.make_key(
            fp, (self.h, self.w), plan_key,
            self.backend, self.interpret, plan.reps, self.warmup,
        )

    def peek_wall(self, plan: RunPlan) -> float | None:
        """A known wall time for this plan, or None — never measures.

        Checks the in-run dedupe table (which a resumed study replays
        into) and then the persistent cache, without charging budget or
        perturbing cache hit/miss statistics. Surrogate strategies use
        this to warm-start from prior knowledge before sampling.
        """
        wall = self._walls.get(plan.key())
        if wall is not None:
            return wall
        if self.cache is not None:
            key = self.cache_key(plan)
            if key is not None:
                rec = self.cache.peek(key)
                if rec is not None:
                    return float(rec["wall_s"])
        return None

    # ---- accounting --------------------------------------------------------

    def remaining(self) -> float:
        """Live measurements left under the budget (inf when unbudgeted)."""
        if self.budget is None:
            return float("inf")
        return max(0, self.budget - self.budget_spent)

    def measurements(self) -> list[dict]:
        """Per-candidate measurement counts: one record per concrete
        plan this search timed live (the ``--json`` schema)."""
        return [
            {**RunPlan(*key).as_dict(), "count": count}
            for key, count in sorted(self._counts.items())
        ]

    # ---- the engine --------------------------------------------------------

    def measure(
        self, point, *, reps: int | None = None
    ) -> ExecutedPoint | None:
        """Legalize, execute and time one design point.

        Returns ``None`` when the point cannot run on this platform
        (more shards than devices, no legal plan, or a back end that
        declines it); raises :exc:`BudgetExhausted` when a live timing
        would exceed the budget. Identical plans — across lattice
        points, strategies, or (via the persistent cache) processes —
        are timed once.
        """
        from .. import measure

        d = max(1, int(point.n))
        if d > self.max_devices:
            self.skipped_devices += 1
            return None
        b = _point_b(point)
        fusion = _point_fusion(point)
        dx = _point_dx(point)
        reps = self.reps if reps is None else int(reps)
        try:
            block_h, m, nsteps, double_buffer = resolve_run_plan(
                self.h, point, self.steps, halo=self.halo,
                width=self.width, words=self.words, d=d, b=b,
                stages=self.stages, fusion=fusion,
                dx=dx, halo_x=self.halo_x,
            )
        except ValueError:
            self.skipped_illegal += 1
            return None
        plan = RunPlan(block_h, m, nsteps, d, reps, double_buffer, b,
                       fusion, dx)

        cached = True
        wall = self._walls.get(plan.key())  # in-run dedupe, cache-independent
        if wall is None:
            run = self._factory_run(plan)
            if run is None:
                self.declined += 1
                return None  # this back end cannot execute the point
            key = None
            if self.cache is not None:
                key = self.cache_key(plan)
                if key is not None:
                    rec = self.cache.get(key)
                    if rec is not None:
                        wall = float(rec["wall_s"])
            if wall is None:
                if self.budget is not None and self.budget_spent >= self.budget:
                    # Remember the candidate this cut-off interrupted:
                    # SearchStepper hands it to prefetch() so its
                    # compile/warm-up overlaps the caller's ticks.
                    self.last_blocked = point
                    raise BudgetExhausted(
                        f"measurement budget of {self.budget} exhausted "
                        f"before timing plan {plan.as_dict()}"
                    )
                # Timed reps never overlap a background warm-up: wait
                # out any in-flight prefetch before the clock starts.
                self._join_prefetch()
                wall, record = self._time(plan, run)
                self.budget_spent += 1
                self._counts[plan.key()] = self._counts.get(plan.key(), 0) + 1
                cached = False
                if self.cache is not None and key is not None:
                    self.cache.put(key, record)
            self._walls[plan.key()] = wall

        sites = self.h * self.w * nsteps * b  # every batch member counts
        flops_per_elem = self.workload.flops_per_elem
        mlups = sites / wall / 1e6
        measured = sites * flops_per_elem / wall / 1e9
        predicted = point.sustained_gflops
        calibrated = None
        if self.calibrate:
            # Predict the geometry actually run (legalized plan, not the
            # raw lattice pick) under the measured platform constants.
            calibrated = self._calibrated_model(d, (block_h, m)).evaluate(
                self.workload, block_h, m, d=d, double_buffer=double_buffer,
                b=b, fusion=fusion, dx=dx,
            ).sustained_gflops
        headline = calibrated if calibrated is not None else predicted
        executed = ExecutedPoint(
            point=point,
            block_h=block_h,
            m=m,
            d=d,
            steps=nsteps,
            wall_s=wall,
            measured_mlups=mlups,
            measured_gflops=measured,
            predicted_gflops=predicted,
            rel_error=(headline - measured) / headline if headline else 0.0,
            interpret=self.interpret,
            calibrated_gflops=calibrated,
            rel_error_model=(
                (predicted - measured) / predicted if predicted else 0.0
            ),
            cached=cached,
            reps=reps,
            double_buffer=double_buffer,
            b=b,
            fusion=fusion,
            dx=dx,
        )
        if self.study is not None:
            self.study.record_trial(self, executed, **self.study_meta)
        return executed

    def log_violation(self, coords: tuple, violation: float) -> None:
        """Journal an infeasible candidate to the attached study.

        Surrogate strategies call this when they observe a candidate
        with a positive :func:`~repro_torch.core.legalize.constraint_violation`
        distance; the study keeps it so a resumed search re-learns the
        infeasible region without re-deriving it. A no-op without a
        study.
        """
        if self.study is not None:
            self.study.record_violation(
                self, tuple(coords), float(violation), **self.study_meta
            )

    # ---- next-candidate prefetch (docs/pipeline.md §search) ---------------

    def prefetch(self, point=None) -> bool:
        """Dispatch a candidate's compile/warm-up on idle devices.

        The minimal parallel-trial-execution seam: when the trial under
        measurement uses fewer than the platform's devices
        (``plan.d < max_devices``), the *next* candidate's un-timed
        warm-up call runs on a background thread so its compile overlaps
        the caller's ticks instead of the next timed step.
        ``point=None`` consumes :attr:`last_blocked` — the candidate the
        last :exc:`BudgetExhausted` cut off, which is exactly what the
        strategy will ask for next (:class:`SearchStepper` relies on
        this). Measured wall-clock stays per-trial-isolated:
        :meth:`measure` joins any in-flight warm-up before its timed
        reps start, so timings never overlap. Returns ``True`` when a
        warm-up was dispatched.
        """
        if point is None:
            point, self.last_blocked = self.last_blocked, None
        if point is None:
            return False
        plan = self.plan_for(point)
        if plan is None or self._walls.get(plan.key()) is not None:
            return False
        if plan.d >= self.max_devices:
            return False  # the mesh uses every device: nothing is idle
        if self._prefetch is not None:
            if self._prefetch[1].is_alive():
                return False  # one in-flight warm-up at a time
            self._prefetch = None
        run = self._factory_run(plan)
        if run is None:
            return False
        import threading

        from .. import measure

        device = self.device

        def warm():
            try:
                # The current CUDA device is per thread in PyTorch.
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                measure.block_until_ready(run())
            except Exception:  # the timed run raises it again
                pass  # a failing warm-up must never kill the search

        thread = threading.Thread(target=warm, daemon=True)
        thread.start()
        self._prefetch = (plan.key(), thread)
        self.prefetched += 1
        return True

    def _join_prefetch(self) -> None:
        """Wait out any in-flight warm-up (timed reps never overlap it)."""
        if self._prefetch is not None:
            self._prefetch[1].join()
            self._prefetch = None

    # ---- internals ---------------------------------------------------------

    def _factory_run(self, plan: RunPlan):
        """Build the nullary launch callable for a concrete plan.

        One dispatch chain shared by :meth:`measure` and
        :meth:`prefetch`: newer factory kwargs (``fusion``/``b``/``dx``)
        are only passed when the plan needs them, so legacy and custom
        back ends keep working unmodified; a back end that cannot
        express the plan returns (or is treated as) ``None``.
        """
        nsteps, m, block_h = plan.steps, plan.m, plan.block_h
        d, double_buffer, b = plan.d, plan.double_buffer, plan.b
        fusion, dx = plan.fusion, plan.dx
        if dx != 1:
            # Mesh plans need a dx-aware factory (DESIGN.md §15); back
            # ends that predate the axis cannot execute them.
            kwargs = {"b": b, "dx": dx}
            if fusion:
                kwargs["fusion"] = fusion
            try:
                return self.run_factory(nsteps, m, block_h, d,
                                        double_buffer, **kwargs)
            except TypeError:
                return None
        if fusion:
            # Program plans need a fusion-aware factory; single-core
            # back ends never see the kwarg for the "" spec.
            return self.run_factory(nsteps, m, block_h, d,
                                    double_buffer, b=b, fusion=fusion)
        if b != 1:
            # Batched plans need a batch-aware factory; older ones
            # (and custom back ends) never see the kwarg for b=1.
            return self.run_factory(nsteps, m, block_h, d,
                                    double_buffer, b=b)
        return self.run_factory(nsteps, m, block_h, d, double_buffer)

    def _time(self, plan: RunPlan, run: Callable) -> tuple[float, dict]:
        """One live timing: the injected timer or the honest harness."""
        from .. import measure

        if self.timer is not None:
            wall = float(self.timer(plan, run, plan.reps, self.warmup))
            return wall, {
                "wall_s": wall, "reps": plan.reps, "warmup": self.warmup,
            }
        timing = measure.time_run(run, reps=plan.reps, warmup=self.warmup)
        return timing.wall_s, {
            "wall_s": timing.wall_s,
            "times_s": list(timing.times_s),
            "reps": timing.reps,
            "warmup": timing.warmup,
            "overhead_s": timing.overhead_s,
        }

    def _calibrated_model(self, d: int, fallback_plan: tuple[int, int]):
        """Calibrated GPUModel for device count d (one probe per d).

        When none of the default probe anchors has a legal plan on this
        grid (e.g. a VMEM-tight width), the point's own legalized
        ``(block_h, m)`` — which just legalized, so it always works —
        becomes the anchor.
        """
        from .. import measure

        model = self._cal_models.get(d)
        if model is None:
            kw = dict(
                workload=self.workload,
                grid_shape=(self.h, self.w),
                halo=self.halo,
                width=self.width,
                words=self.words,
                d_values=(d,),
                device=self.device,
                reps=self.reps,
                warmup=self.warmup,
                cache=self.cache,
                fingerprint=self.fingerprint,
                mem_gbs=self._cal_mem[0] if self._cal_mem else None,
            )
            self._join_prefetch()  # probes are timed reps too
            try:
                cal = measure.calibrate_execution(self.run_factory, **kw)
            except ValueError:
                kw["probe_plans"] = (fallback_plan,)
                cal = measure.calibrate_execution(self.run_factory, **kw)
            if not self._cal_mem:
                self._cal_mem.append(cal.mem_gbs)
            model = self._cal_models[d] = cal.model(d=d)
        return model
