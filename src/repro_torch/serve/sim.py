"""Simulation-as-a-service: a multi-tenant stream-simulation engine.

The port of the JAX package's ``serve/sim.py`` (docs/pipeline.md §serve,
docs/port.md §serve): clients :meth:`~SimEngine.submit`
:class:`SimRequest`\\ s — an SPD core, a packed ``(P, H, W)`` grid state,
a step count — and the engine serves them in fused ticks at each
tenant's *tuned* operating point. Three mechanisms make that work:

* **Trial-context slot table** — requests group by
  :class:`TrialContext`: the core's DFG fingerprint, the grid shape,
  the ``Append_Reg`` values and the execution path (the kernel's device
  type, ``"cuda"`` or ``"cpu"``). Only identical contexts may share a
  launch (the batched kernel passes one register vector to every
  member, and plans tuned for one geometry mean nothing for another).
* **Batch axis b** — compatible requests stack into one ``(b, P, H, W)``
  launch of the generated kernel (:mod:`repro_torch.kernels.spd_stream`),
  bitwise identical per member to ``b`` separate launches. A tick
  advances a group ``min(plan.m, members' remaining)`` fused steps in
  one launch.
* **Autotune-on-first-request** — the first sight of a context opens a
  :class:`PlanResolver` session: a budgeted search (default
  :class:`~repro_torch.core.search.TPESearch`) over the H100 model's
  ``(block_h, m, b)`` lattice through the shared
  :class:`~repro_torch.core.search.SearchRunner`, journaled to a named
  per-context :class:`~repro_torch.core.search.Study`. The search is
  driven **non-blockingly** through
  :class:`~repro_torch.core.search.SearchStepper` — one live timing per
  engine tick, interleaved with serving other tenants — under a hard
  per-context ``budget``. When the budget runs out mid-tune the engine
  falls back to the best measured point so far, or to the model's plan
  when nothing was measured. Warm restarts replay the study journal and
  pin the plan with **zero** live timings. Studies and the measurement
  cache live at the port's own paths (``$REPRO_TORCH_STUDY_DIR``,
  ``$REPRO_TORCH_MEASURE_CACHE``, under ``build/repro_torch/``).

The state's device picks the path everywhere in the port: a CUDA state
launches the kernel, a CPU state runs its plain version. So the engine
moves every state to the kernel's device at admission (a request may
arrive as numpy or as a CPU tensor) and again when it re-forms a cohort
(survivors come back from the host), and refuses a CUDA state given to
an engine on the CPU. A cohort's dissolution is one ``.cpu()`` of the
stacked state.

The engine waits on the card only where the host reads device data;
everything else is ordered by the stream. A launch is the call of the
kernel alone: the next launch of its cohort, and the launches of other
contexts in the same tick, queue behind it on the current stream while
the host goes on. The host blocks (``torch.cuda.synchronize`` of the
card, the counterpart of ``jax.block_until_ready``) before a
dissolution's ``.cpu()``, before a live tuning timing (so launches queued
by other contexts never land in it) and before copying a host state to
the card (a copy from pageable memory waits behind the queue anyway).
The device type decides: a CPU engine has nothing to wait on.

The tick's phases are host spans under a profiler
(:mod:`repro_torch.tracing`): ``sim.admit`` a request, ``sim.form`` a
width-1 cohort, ``sim.enqueue`` the call of the kernel (``spd.launch``
inside it: the launch's own host work), ``sim.dissolve`` a cohort.
:meth:`SimEngine.stats` splits the tick on the host clock: ``tick_s``
inside :meth:`~SimEngine.step`; ``launch_wall_s`` and ``enqueue_s`` the
call of the kernel, the same interval now that nothing waits after it;
``dissolve_s`` the wait for the card, the ``.cpu()`` and the completions.
``waits`` counts the host's blocking waits on the card and ``wait_s``
sums them: the dissolutions' are part of ``dissolve_s``, a tuning drain's
or a host copy's part of the tick's other host work.

Accounting mirrors ``serve/engine.py``'s tick idioms: a bounded
admission queue that rejects with backpressure when full
(:meth:`SimEngine.submit` returns ``False``), per-request queue-wait /
service / latency accounting, a batch-occupancy histogram, and
:meth:`SimEngine.run_until_drained`, which raises instead of silently
truncating.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.tracing import span

__all__ = [
    "PlanResolver",
    "SimCompletion",
    "SimEngine",
    "SimPlan",
    "SimRequest",
    "TrialContext",
    "TuningSession",
]


# --------------------------------------------------------------------------
# Requests, contexts, plans
# --------------------------------------------------------------------------


@dataclass
class SimRequest:
    """One tenant's simulation job: advance ``state`` by ``steps``.

    ``core`` is a :class:`~repro_torch.core.compiler.CompiledCore` or an
    already-lowered :class:`~repro_torch.core.codegen.StreamKernel`;
    ``state`` the packed ``(P, H, W)`` grid (``StreamKernel.pack``), a
    tensor or a numpy array; ``regs`` the core's ``Append_Reg`` values.
    """

    rid: int
    core: object
    state: object
    steps: int
    regs: tuple = ()


@dataclass
class SimCompletion:
    """A retired request: final state (numpy) plus per-request
    accounting."""

    rid: int
    state: np.ndarray
    steps: int
    submitted_tick: int
    admitted_tick: int
    finished_tick: int
    submitted_s: float
    finished_s: float

    @property
    def latency_s(self) -> float:
        """Submit→retire wall latency (what the load generator reports)."""
        return self.finished_s - self.submitted_s


@dataclass(frozen=True)
class TrialContext:
    """What must match for two requests to share a launch — and for a
    serving-time tuning to be cache/study-compatible with offline sweeps
    (docs/pipeline.md §study): the core's DFG fingerprint, the concrete
    grid, the register values (passed to every batch member) and the
    execution path, the kernel's device type (``"cuda"`` or ``"cpu"``)."""

    fingerprint: str
    h: int
    w: int
    regs: tuple
    device: str


@dataclass(frozen=True)
class SimPlan:
    """The pinned operating point a context serves at.

    ``b`` is the *maximum* batch width — a tick launches
    ``min(b, waiting members)`` wide; ``source`` records how the plan
    was won: ``"search"`` (live tuning, including study-warm-started
    runs that spent zero budget), ``"model"`` (budget exhausted before
    any measurement — the model's plan).
    """

    block_h: int
    m: int
    d: int
    double_buffer: bool
    b: int
    source: str
    budget_spent: int = 0
    replayed: int = 0

    def as_dict(self) -> dict:
        return {
            "block_h": int(self.block_h),
            "m": int(self.m),
            "d": int(self.d),
            "double_buffer": bool(self.double_buffer),
            "b": int(self.b),
            "source": self.source,
            "budget_spent": int(self.budget_spent),
            "replayed": int(self.replayed),
        }


# --------------------------------------------------------------------------
# Autotune-on-first-request
# --------------------------------------------------------------------------


class TuningSession:
    """One context's in-flight autotune: a stepper the tick loop drives.

    Wraps :class:`~repro_torch.core.search.SearchStepper` so the engine
    advances the search one live timing per tick; :meth:`advance`
    returns the pinned :class:`SimPlan` once the search converges or
    exhausts its budget, ``None`` while tuning is still in flight.
    ``legalize(point) -> (block_h, m, steps, double_buffer)`` turns the
    model's plan into one the grid takes (the reference pins the model's
    raw ``block_rows``, which may exceed the grid and then fails at the
    first launch).
    """

    def __init__(self, stepper, sweep, study_name: str | None,
                 replayed: int, legalize):
        self.stepper = stepper  # None: budget 0, the model's plan
        self.sweep = sweep
        self.study_name = study_name
        self.replayed = replayed
        self.legalize = legalize
        self.plan: SimPlan | None = None

    @property
    def live_timings(self) -> int:
        return 0 if self.stepper is None else (
            self.stepper.runner.budget_spent
        )

    def advance(self) -> SimPlan | None:
        if self.plan is not None:
            return self.plan
        if self.stepper is None:
            best, spent = None, 0
        else:
            self.stepper.step()
            if not self.stepper.done:
                return None
            best = self.stepper.best()
            spent = self.stepper.runner.budget_spent
        if best is not None:
            self.plan = SimPlan(
                block_h=best.block_h, m=best.m, d=best.d,
                double_buffer=best.double_buffer, b=best.b,
                source="search", budget_spent=spent,
                replayed=self.replayed,
            )
        else:
            # Budget exhausted (or nothing runnable) before a single
            # measurement: fall back to the model's plan.
            pt = self.sweep.best(key="sustained_gflops")
            block_h, m, _, double_buffer = self.legalize(pt)
            self.plan = SimPlan(
                block_h=block_h, m=m, d=max(1, int(pt.n)),
                double_buffer=double_buffer,
                b=int((pt.detail or {}).get("b", 1)),
                source="model", budget_spent=spent,
                replayed=self.replayed,
            )
        return self.plan


class PlanResolver:
    """Study store → measurement cache → budgeted search, in that order.

    The resolution ladder (docs/pipeline.md §serve): a named per-context
    :class:`~repro_torch.core.search.Study` is resumed and replayed into
    the runner's dedupe table (a fully journaled context re-measures
    nothing), the :class:`~repro_torch.core.measure.MeasurementCache`
    (``cache``; none by default, ``True`` for the port's on-disk cache)
    serves plans other processes timed, and only what neither knows is
    measured live — at most ``budget`` timings per context, ever, on the
    device of the context's state. ``timer`` injects the timing primitive
    for deterministic tests; ``study_dir`` defaults to the port's study
    directory (``$REPRO_TORCH_STUDY_DIR``).
    """

    def __init__(
        self,
        *,
        strategy="tpe",
        budget: int = 8,
        b_values: Sequence[int] = (1, 2, 4),
        bh_values: Sequence[int] = (8, 16, 32, 64),
        m_values: Sequence[int] = (1, 2, 4, 8),
        d_values: Sequence[int] = (1,),
        steps: int | None = None,
        reps: int = 1,
        warmup: int = 1,
        calibrate: bool = False,
        cache=None,
        study_dir: str | None = None,
        study_prefix: str = "serve",
        timer=None,
    ):
        self.strategy = strategy
        self.budget = int(budget)
        self.b_values = tuple(int(v) for v in b_values)
        self.bh_values = tuple(int(v) for v in bh_values)
        self.m_values = tuple(int(v) for v in m_values)
        self.d_values = tuple(int(v) for v in d_values)
        self.steps = steps
        self.reps = int(reps)
        self.warmup = int(warmup)
        self.calibrate = bool(calibrate)
        self.cache = cache
        self.study_dir = study_dir
        self.study_prefix = study_prefix
        self.timer = timer

    def study_name(self, ctx: TrialContext) -> str:
        """Stable per-context study identity: resuming an engine with the
        same resolver settings re-opens the same journal."""
        return (
            f"{self.study_prefix}-{ctx.fingerprint[:12]}-{ctx.h}x{ctx.w}"
        )

    def open(self, kern, state, ctx: TrialContext) -> TuningSession:
        """Start (or warm-start) this context's tuning session; ``state``
        (on the context's device) is what the search times."""
        from repro_torch.core.explorer import Explorer
        from repro_torch.core.legalize import resolve_run_plan
        from repro_torch.core.search import (
            SearchRunner,
            SearchStepper,
            Study,
            get_strategy,
            kernel_run_factory,
        )
        from repro_torch.core.search.surrogate import TPESearch

        ex = Explorer(kern.compiled, elems=ctx.h * ctx.w, grid_w=ctx.w)
        sweep = ex.sweep_gpu(
            bh_values=self.bh_values, m_values=self.m_values,
            d_values=self.d_values, b_values=self.b_values,
        )

        def legalize(point):
            return resolve_run_plan(ctx.h, point, halo=kern.halo)

        if self.budget <= 0:
            # Serving at the model's plan: no runner, no study, no live
            # measurements — advance() pins the sweep's best point
            # immediately (the same fallback an exhausted budget takes).
            return TuningSession(None, sweep, None, 0, legalize)
        strat = self.strategy
        if isinstance(strat, str) and strat == "tpe":
            # Bound *observations* at the budget so a warm-started
            # session whose journal already covers them measures zero.
            strat = TPESearch(max_trials=self.budget)
        strat = get_strategy(strat)
        runner = SearchRunner(
            workload=sweep.workload,
            grid_shape=(ctx.h, ctx.w),
            run_factory=kernel_run_factory(kern, state, ctx.regs),
            model=sweep.model,
            scalar_kwargs=sweep.scalar_kwargs,
            fingerprint=ctx.fingerprint,
            halo=kern.halo,
            width=ctx.w,
            words=len(kern._ports),
            steps=self.steps,
            device=state.device,
            reps=self.reps,
            warmup=self.warmup,
            calibrate=self.calibrate,
            cache=self.cache,
            budget=self.budget,
            timer=self.timer,
        )
        study = Study.resume(self.study_name(ctx), self.study_dir)
        replayed = study.replay_into(runner)
        runner.study = study
        runner.study_meta = {
            "strategy": strat.name,
            "seed": getattr(strat, "seed", None),
        }
        stepper = SearchStepper(strat, sweep, runner)
        return TuningSession(stepper, sweep, study.name, replayed, legalize)


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


@dataclass
class _Active:
    """One admitted request's slot-table entry."""

    req: SimRequest
    state: object  # (P, H, W): a tensor on the kernel's device, or the
    # numpy view a dissolved cohort handed back
    remaining: int
    submitted_tick: int
    submitted_s: float
    admitted_tick: int


@dataclass
class _Cohort:
    """A formed launch batch that *stays stacked* between launches.

    Stacking (``pack_batch``) and unstacking (one device→host transfer)
    happen once per cohort, not once per launch: restacking every tick
    would hand back the host overhead the batch axis amortizes. The
    cohort dissolves when any member finishes; survivors rejoin the
    FIFO with host states and re-stack, on the kernel's device, into the
    next cohort."""

    members: list
    stacked: object  # (b, P, H, W) tensor when len > 1, else (P, H, W)


@dataclass
class _Group:
    """All live state for one trial context: its kernel, its (eventual)
    pinned plan, the FIFO of admitted members, and the in-flight
    cohort."""

    kern: object
    ctx: TrialContext
    session: TuningSession | None = None
    plan: SimPlan | None = None
    members: deque = field(default_factory=deque)
    cohort: _Cohort | None = None


class SimEngine:
    """Multi-tenant stream-simulation serving engine (docs/port.md
    §serve).

    ``max_queue`` bounds admission — :meth:`submit` returns ``False``
    (backpressure) when full, and the rejection is counted, never
    dropped silently. ``max_active`` bounds the slot table across all
    contexts. Each :meth:`step` tick admits, advances at most one
    tuning measurement per still-cold context, and launches one fused
    batched step per warm context. ``device`` is where the engine's
    kernels run: the card unless the caller asks for ``"cpu"``.
    """

    def __init__(
        self,
        resolver: PlanResolver | None = None,
        *,
        max_queue: int = 64,
        max_active: int = 64,
        device="cuda",
    ):
        from repro_torch.interop import resolve_device

        self.resolver = resolver or PlanResolver()
        self.device = resolve_device(device)
        self.max_queue = int(max_queue)
        self.max_active = int(max_active)
        self.queue: deque = deque()  # (req, submitted_tick, submitted_s)
        self.groups: dict[TrialContext, _Group] = {}
        self._kern_cache: dict[int, tuple[str, object]] = {}
        self.tick_count = 0
        # ---- accounting ---------------------------------------------------
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.launches = 0
        self.member_steps = 0  # Σ (fused steps × members) over launches
        self.enqueue_s = 0.0  # inside kern(...): a launch's whole wall
        self.dissolve_s = 0.0  # wait, .cpu() of a cohort, its completions
        self.tick_s = 0.0  # inside step()
        self.waits = 0  # the host's blocking waits on the card
        self.wait_s = 0.0
        self.occupancy: dict[int, int] = {}  # launch width -> count
        self.tuning_ticks = 0  # ticks that advanced a search instead

    def reset_counters(self) -> None:
        """Open a fresh measurement window: zero the aggregate launch
        and admission accounting while keeping every pinned plan, built
        kernel and in-flight member. The load generator uses this to
        report *steady-state* throughput — a warmup pass absorbs the
        one-time per-shape build and tuning cost, then the window resets
        and the measured pass sees only real launch work."""
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.launches = 0
        self.member_steps = 0
        self.enqueue_s = 0.0
        self.dissolve_s = 0.0
        self.tick_s = 0.0
        self.waits = 0
        self.wait_s = 0.0
        self.occupancy = {}
        self.tuning_ticks = 0

    # ---- admission ---------------------------------------------------------

    def submit(self, req: SimRequest) -> bool:
        """Enqueue a request; ``False`` = queue full (backpressure).

        A CUDA state given to an engine on the CPU raises ``ValueError``:
        it would run the plain version on the host without a word."""
        if isinstance(req.state, torch.Tensor) and \
                req.state.device.type != "cpu" and \
                req.state.device.type != self.device.type:
            raise ValueError(
                f"request {req.rid}: a {req.state.device} state given to "
                f"an engine on {self.device}; pass device="
                f"{req.state.device.type!r} to the engine"
            )
        if len(self.queue) >= self.max_queue:
            self.rejected += 1
            return False
        self.submitted += 1
        self.queue.append((req, self.tick_count, time.monotonic()))
        return True

    def _kernel_for(self, core) -> tuple[str, object]:
        """Lower (and fingerprint) a submitted core, once per object, on
        the engine's device; a lowered kernel must already live there."""
        from repro_torch.core import measure
        from repro_torch.core.codegen import StreamKernel

        hit = self._kern_cache.get(id(core))
        if hit is not None:
            return hit
        if isinstance(core, StreamKernel):
            if core.device.type != self.device.type:
                raise ValueError(
                    f"a StreamKernel on {core.device} given to an engine "
                    f"on {self.device}"
                )
            kern = core
        else:
            kern = core.stream_kernel(device=self.device)
        fp = measure.core_fingerprint(kern)
        self._kern_cache[id(core)] = (fp, kern)
        return fp, kern

    def _active_count(self) -> int:
        return sum(
            len(g.members)
            + (len(g.cohort.members) if g.cohort is not None else 0)
            for g in self.groups.values()
        )

    def _wait(self, device) -> None:
        """Block the host until ``device`` has run everything queued on
        it, counted in ``waits`` and ``wait_s``; a CPU device has nothing
        queued."""
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        self.waits += 1
        self.wait_s += time.perf_counter() - t0

    @staticmethod
    def _elsewhere(state, device) -> bool:
        return not isinstance(state, torch.Tensor) or \
            state.device.type != device.type

    def _to_device(self, state, device):
        """``state`` as an f32 tensor on ``device``. A host state's copy
        would block behind the queued launches: wait for them first, so
        the wait is counted."""
        from repro_torch.interop import from_numpy

        if self._elsewhere(state, device):
            self._wait(device)
        return from_numpy(state, device)

    def _admit(self) -> None:
        while self.queue and self._active_count() < self.max_active:
            # One span a request: each may copy its state to the card.
            with span("sim.admit"):
                req, tick, t_s = self.queue.popleft()
                fp, kern = self._kernel_for(req.core)
                h, w = int(req.state.shape[-2]), int(req.state.shape[-1])
                ctx = TrialContext(
                    fingerprint=fp, h=h, w=w,
                    regs=tuple(float(r) for r in req.regs),
                    device=kern.device.type,
                )
                group = self.groups.get(ctx)
                if group is None:
                    group = self.groups[ctx] = _Group(kern=kern, ctx=ctx)
                group.members.append(_Active(
                    req=req, state=self._to_device(req.state, kern.device),
                    remaining=int(req.steps), submitted_tick=tick,
                    submitted_s=t_s, admitted_tick=self.tick_count,
                ))

    # ---- the tick loop ------------------------------------------------------

    def step(self) -> list[SimCompletion]:
        """One engine tick: admit, tune-or-launch per context, retire."""
        t0 = time.perf_counter()
        self.tick_count += 1
        self._admit()
        done: list[SimCompletion] = []
        for group in self.groups.values():
            if not group.members and group.cohort is None:
                continue
            if group.plan is None:
                if group.session is None:
                    # Autotune-on-first-request: open the context's
                    # session (study replay happens here — a warm
                    # journal pins the plan with zero live timings).
                    group.session = self.resolver.open(
                        group.kern, group.members[0].state, group.ctx,
                    )
                if group.session.stepper is not None:
                    # A live timing may follow: drain the launches other
                    # contexts queued, so none lands inside it.
                    self._wait(group.kern.device)
                group.plan = group.session.advance()
                if group.plan is None:
                    self.tuning_ticks += 1
                    continue  # still tuning; members wait in the slot
            done.extend(self._launch(group))
        self.tick_s += time.perf_counter() - t0
        return done

    def _launch(self, group: _Group) -> list[SimCompletion]:
        """One fused batched launch for a warm context.

        The launch drives the group's current :class:`_Cohort` (forming
        one from the member FIFO if none is in flight, every state moved
        to the kernel's device, a width-1 cohort included); the cohort's
        stacked state advances across ticks, and members are sliced back
        out — one host transfer — only when the cohort dissolves. The
        launch is not waited for: the cohort's next launch and its
        dissolution's ``.cpu()`` follow it on the stream."""
        plan = group.plan
        kern = group.kern
        if group.cohort is None:
            batch = [
                group.members.popleft()
                for _ in range(min(plan.b, len(group.members)))
            ]
            if len(batch) == 1:
                # A span encloses one copy at most: a stack of several
                # host states goes without.
                with span("sim.form"):
                    stacked = self._to_device(batch[0].state, kern.device)
            else:
                if any(self._elsewhere(a.state, kern.device) for a in batch):
                    self._wait(kern.device)  # host states to copy
                stacked = kern.pack_batch([a.state for a in batch])
            group.cohort = _Cohort(batch, stacked)
        co = group.cohort
        mm = min([plan.m] + [a.remaining for a in co.members])
        t0 = time.perf_counter()
        with span("sim.enqueue"):
            out = kern(
                co.stacked, group.ctx.regs, m=mm, block_h=plan.block_h,
                double_buffer=plan.double_buffer,
            )
        self.enqueue_s += time.perf_counter() - t0
        co.stacked = out
        width = len(co.members)
        self.launches += 1
        self.member_steps += mm * width
        self.occupancy[width] = self.occupancy.get(width, 0) + 1
        for active in co.members:
            active.remaining -= mm

        done: list[SimCompletion] = []
        if not any(a.remaining <= 0 for a in co.members):
            return done  # cohort stays stacked and in flight
        t0 = time.perf_counter()
        with span("sim.dissolve"):
            self._wait(out.device)  # the host reads the card: wait for it
            host = out.cpu().numpy()  # one transfer for the whole cohort
            now = time.monotonic()
            survivors = []
            for i, active in enumerate(co.members):
                state = host[i] if width > 1 else host
                if active.remaining > 0:
                    active.state = state  # restacked into the next cohort
                    survivors.append(active)
                    continue
                self.completed += 1
                done.append(SimCompletion(
                    rid=active.req.rid,
                    state=state,
                    steps=int(active.req.steps),
                    submitted_tick=active.submitted_tick,
                    admitted_tick=active.admitted_tick,
                    finished_tick=self.tick_count,
                    submitted_s=active.submitted_s,
                    finished_s=now,
                ))
            group.members.extend(survivors)  # back of the FIFO
            group.cohort = None
        self.dissolve_s += time.perf_counter() - t0
        return done

    def run_until_drained(self, max_ticks: int = 10_000) -> list[SimCompletion]:
        """Tick until every queued and admitted request retires.

        Mirrors ``serve/engine.py``: hitting ``max_ticks`` with work
        still pending raises ``RuntimeError`` naming the undrained
        request ids instead of silently truncating.
        """
        out: list[SimCompletion] = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.queue and self._active_count() == 0:
                return out
        undrained = [a.req.rid for g in self.groups.values()
                     for a in g.members]
        undrained += [a.req.rid for g in self.groups.values()
                      if g.cohort is not None for a in g.cohort.members]
        undrained += [req.rid for req, _, _ in self.queue]
        raise RuntimeError(
            f"run_until_drained hit max_ticks={max_ticks} with "
            f"{len(undrained)} request(s) undrained (rids {undrained}); "
            f"{len(out)} completion(s) were produced before the bound"
        )

    # ---- reporting ----------------------------------------------------------

    @staticmethod
    def _plan_key(ctx: TrialContext) -> str:
        """Human-readable stats key covering the *whole* context —
        including the register values, which distinguish contexts that
        share a fingerprint and grid (e.g. two diffusion tenants with
        different alphas)."""
        key = f"{ctx.fingerprint[:12]}-{ctx.h}x{ctx.w}"
        if ctx.regs:
            key += "-r" + ",".join(f"{r:g}" for r in ctx.regs)
        return key

    def stats(self) -> dict:
        """Engine-level accounting: the load generator's raw material."""
        live = sum(
            g.session.live_timings
            for g in self.groups.values() if g.session is not None
        )
        return {
            "ticks": int(self.tick_count),
            "submitted": int(self.submitted),
            "rejected": int(self.rejected),
            "completed": int(self.completed),
            "launches": int(self.launches),
            "member_steps": int(self.member_steps),
            # nothing waits after the call: a launch's wall is its enqueue
            "launch_wall_s": float(self.enqueue_s),
            "enqueue_s": float(self.enqueue_s),
            "dissolve_s": float(self.dissolve_s),
            "tick_s": float(self.tick_s),
            "waits": int(self.waits),
            "wait_s": float(self.wait_s),
            "steps_per_s": (
                self.member_steps / self.enqueue_s
                if self.enqueue_s > 0 else 0.0
            ),
            "occupancy": {
                str(k): int(v) for k, v in sorted(self.occupancy.items())
            },
            "tuning_ticks": int(self.tuning_ticks),
            "live_timings": int(live),
            "plans": {
                self._plan_key(ctx):
                    g.plan.as_dict() if g.plan is not None else None
                for ctx, g in self.groups.items()
            },
        }
