"""Search strategies over the (n, m, d, block_h) design lattice.

A copy of the JAX package's ``core/search/strategies.py`` (framework-free;
docs/port.md §dse), held to it by ``tests/test_torch_search.py``.

The paper's workflow is a *search* problem — find the best mix of
temporal and spatial parallelism under resource and bandwidth
constraints — and this module is where the searching happens
(docs/pipeline.md §search, DESIGN.md §10). A strategy is anything
satisfying :class:`SearchStrategy`: given a model :class:`Sweep` (the
batched lattice evaluation, docs/pipeline.md §execute) and a
:class:`~repro_torch.core.search.runner.SearchRunner` (the one legalize→run→
time engine), it decides *which points to spend measurements on* and
returns the executed points, newest last. Three ship:

* :class:`ExhaustiveSearch` — the repo's original behavior, now one
  strategy among peers: walk the model's Pareto frontier best-first
  (or the whole feasible lattice with ``frontier_only=False``) and
  measure until ``k`` points have executed or the budget is gone.
* :class:`LocalRefine` — model-seeded hill-climb: measure the top
  frontier seeds, then step through the (block_h, m, d) neighborhood of
  the best measured point — block_h moves along the *legal divisor
  chain* (:func:`repro_torch.core.legalize.legal_block_values`), which is
  what promotes it from a legalization byproduct to a first-class
  searched dimension — and keep moving while measurements improve.
* :class:`SuccessiveHalving` — budgeted racing: screen a wide,
  model-ranked, plan-deduped candidate pool with cheap low-rep
  timings, promote the measured-best ``1/eta`` fraction to the next
  rung with ``eta×`` the reps, and finish the survivors at full reps —
  so most of the budget lands on the candidates measurement (not the
  model) says are best.

Every strategy runs through the same runner, so they share the plan
dedupe table, the calibration anchors, the measurement cache, and the
hard budget (:exc:`~repro_torch.core.search.runner.BudgetExhausted` ends a
search mid-flight; whatever was measured is returned).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from ..legalize import legal_block_values
from .runner import BudgetExhausted, ExecutedPoint, SearchRunner

__all__ = [
    "ExhaustiveSearch",
    "LocalRefine",
    "STRATEGIES",
    "SearchStepper",
    "SearchStrategy",
    "SuccessiveHalving",
    "get_strategy",
]


@runtime_checkable
class SearchStrategy(Protocol):
    """What the Explorer facade needs from a strategy.

    ``name`` identifies the strategy in reports (CLI ``--strategy``
    values, ``BENCH_dse.json``); ``search`` spends the runner's budget
    and returns the executed points in measurement order.
    """

    name: str

    def search(
        self, sweep, runner: SearchRunner
    ) -> list[ExecutedPoint]: ...


def _ranked_candidates(sweep, runner: SearchRunner) -> list:
    """All feasible lattice points, model-best first, deduped by plan.

    Lattice points that legalize to the same concrete run plan are one
    candidate (the model-best spelling wins); points this platform
    cannot run (device-starved, no legal plan) are dropped up front so
    no strategy wastes budget discovering that.
    """
    feas = np.flatnonzero(sweep.feasible)
    order = np.argsort(
        -np.asarray(sweep.data["sustained_gflops"], float)[feas]
    )
    seen: set = set()
    out = []
    for i in feas[order]:
        pt = sweep.point(int(i))
        plan = runner.plan_for(pt)
        if plan is None:
            continue
        dedup = (plan.block_h, plan.m, plan.steps, plan.d,
                 plan.double_buffer, plan.b, plan.fusion, plan.dx)
        if dedup in seen:
            continue
        seen.add(dedup)
        out.append(pt)
    return out


@dataclass
class ExhaustiveSearch:
    """Measure the model's ranking top-down — the original explorer loop.

    With ``frontier_only=True`` (the default, and the
    ``execute_frontier`` facade) the walk is over the Pareto frontier —
    a handful of points — stopping after ``k`` executed points when
    ``k`` is set. ``frontier_only=False`` measures every feasible,
    runnable, plan-deduped lattice point (budget permitting) — the
    expensive ground-truth reference the cheaper strategies are judged
    against in ``tests/test_search.py``; ask for it explicitly.
    """

    name = "exhaustive"
    k: int | None = None
    frontier_only: bool = True

    def search(self, sweep, runner: SearchRunner) -> list[ExecutedPoint]:
        if self.frontier_only:
            candidates = sweep.frontier()
        else:
            candidates = _ranked_candidates(sweep, runner)
        out: list[ExecutedPoint] = []
        for pt in candidates:
            if self.k is not None and len(out) >= self.k:
                break
            try:
                e = runner.measure(pt)
            except BudgetExhausted:
                break
            if e is not None:
                out.append(e)
        return out


@dataclass
class LocalRefine:
    """Model-seeded hill-climb over the (block_h, m, d) neighborhood.

    The model proposes, measurement disposes: the top ``seeds``
    frontier points are measured, then the best measured point's
    one-coordinate moves — block_h to the adjacent legal divisors
    (first-class, not just whatever legalization returned), m and d
    halved/doubled, the mesh column axis dx halved/doubled at fixed d
    (DESIGN.md §15), double_buffer flipped (ping/pong vs single-buffer
    streaming, docs/pipeline.md §stream) — are measured, moving
    whenever a neighbor beats the incumbent, until a round yields no
    improvement, ``max_rounds`` is hit, or the budget runs out.
    """

    name = "refine"
    seeds: int = 2
    max_rounds: int = 8

    def search(self, sweep, runner: SearchRunner) -> list[ExecutedPoint]:
        out: list[ExecutedPoint] = []
        seen: set = set()  # plans already in `out` (moves often collapse)
        best: ExecutedPoint | None = None

        def visit(pt) -> ExecutedPoint | None:
            e = runner.measure(pt)
            if e is None:
                return None
            plan = (e.block_h, e.m, e.steps, e.d, e.double_buffer, e.b,
                    e.fusion, e.dx)
            if plan not in seen:
                seen.add(plan)
                out.append(e)
            return e

        try:
            for pt in sweep.frontier()[: max(1, self.seeds)]:
                e = visit(pt)
                if e is not None and (
                    best is None or e.measured_gflops > best.measured_gflops
                ):
                    best = e
            if best is None:
                return out
            for _ in range(self.max_rounds):
                improved = False
                for nb, nm, nd, ndb, ndx in self._neighborhood(best, runner):
                    # Moves stay within the incumbent's fusion partition
                    # (docs/pipeline.md §program) — the fusion axis is
                    # explored by the sweep lattice, not the hill-climb.
                    pt = runner.point(nb, nm, nd, double_buffer=ndb,
                                      fusion=best.fusion or None,
                                      dx=ndx)
                    if pt is None or not pt.feasible:
                        continue
                    e = visit(pt)
                    if e is not None and (
                        e.measured_gflops > best.measured_gflops
                    ):
                        best = e
                        improved = True
                if not improved:
                    break
        except BudgetExhausted:
            pass
        return out

    @staticmethod
    def _neighborhood(best: ExecutedPoint, runner: SearchRunner):
        """One-coordinate moves from the incumbent's *legalized* plan."""
        bh, m, d, db = best.block_h, best.m, best.d, best.double_buffer
        dx = max(1, int(getattr(best, "dx", 1) or 1))
        moves: list[tuple[int, int, int, bool, int]] = []
        # block_h: the adjacent legal divisors for this (m, d, db, dx) —
        # the chain blocking_plan chooses among, searched directly.
        chain = legal_block_values(
            runner.h, m, halo=runner.halo, width=runner.width,
            words=runner.words, d=d, double_buffer=db,
            dx=dx, halo_x=runner.halo_x if dx > 1 else 0,
        )
        below = [v for v in chain if v < bh]
        above = [v for v in chain if v > bh]
        if below:
            moves.append((below[-1], m, d, db, dx))
        if above:
            moves.append((above[0], m, d, db, dx))
        # m: halve / double the fused-step count.
        if m > 1:
            moves.append((bh, max(1, m // 2), d, db, dx))
        moves.append((bh, m * 2, d, db, dx))
        # d: halve / double the device axis within the platform.
        if d > 1 and (d // 2) % dx == 0:
            moves.append((bh, m, d // 2, db, dx))
        if 2 * d <= runner.max_devices and runner.h % (2 * d) == 0:
            moves.append((bh, m, 2 * d, db, dx))
        # dx: reshape the mesh at fixed total device count (DESIGN.md
        # §15) — trade row shards for column shards, the move that
        # matches the mesh to the grid aspect.
        if dx > 1:
            moves.append((bh, m, d, db, dx // 2))
        if d % (2 * dx) == 0 and runner.w % (2 * dx) == 0:
            moves.append((bh, m, d, db, 2 * dx))
        # double_buffer: flip the streamed launch's buffer protocol
        # (ping/pong overlap vs the single-buffer streaming fallback).
        moves.append((bh, m, d, not db, dx))
        return moves


@dataclass
class SuccessiveHalving:
    """Screen wide and cheap, finish narrow and honest.

    Rung 0 measures up to ``n0`` model-ranked candidates at
    ``screen_reps`` (1 by default: one synchronized, warm timing each);
    each next rung keeps the measured-best ``ceil(n/eta)`` and
    multiplies the reps by ``eta``, capped at the runner's full ``reps``
    — the survivors' final numbers are full-rep, same as any other
    strategy's. Under a hard budget ``n0`` is sized so the whole
    schedule fits: n0·(1 + 1/eta + 1/eta² + …) ≤ budget.
    """

    name = "halving"
    eta: int = 3
    screen_reps: int = 1
    n0: int | None = None

    def search(self, sweep, runner: SearchRunner) -> list[ExecutedPoint]:
        if self.eta < 2:
            raise ValueError(f"eta must be >= 2, got {self.eta}")
        candidates = _ranked_candidates(sweep, runner)
        if not candidates:
            return []
        n0 = self.n0
        if n0 is None:
            if runner.budget is not None:
                # geometric schedule total ≈ n0·eta/(eta−1) ≤ remaining
                n0 = max(1, int(runner.remaining() * (self.eta - 1)
                                // self.eta))
            else:
                n0 = len(candidates)
        rung = candidates[: max(1, n0)]
        reps = min(max(1, self.screen_reps), runner.reps)
        out: list[ExecutedPoint] = []
        try:
            while rung:
                scored: list[ExecutedPoint] = []
                for pt in rung:
                    e = runner.measure(pt, reps=reps)
                    if e is None:
                        continue
                    scored.append(e)
                    out.append(e)
                scored.sort(key=lambda e: -e.measured_gflops)
                if not scored or (len(scored) == 1 and reps >= runner.reps):
                    break
                if reps >= runner.reps:
                    # full-rep rung already ran: the survivors are final
                    break
                keep = max(1, math.ceil(len(scored) / self.eta))
                rung = [e.point for e in scored[:keep]]
                reps = min(runner.reps, reps * self.eta)
        except BudgetExhausted:
            pass
        return out


class SearchStepper:
    """Drive any search strategy one live measurement at a time.

    The non-blocking ``suggest/observe`` seam the serving engine's tick
    loop needs (docs/pipeline.md §serve, DESIGN.md §13): a long-running
    service cannot hand the device to ``strategy.search`` for a whole
    budget's worth of timings, but every shipped strategy is
    *deterministic given the runner's dedupe table* — so each
    :meth:`step` simply re-runs the strategy under a budget of
    ``spent + 1``. Everything earlier steps measured replays for free
    from the table, the strategy fast-forwards to its next unmeasured
    candidate, times exactly that one, and is cut off. One step ≈ one
    kernel timing; ticks interleave in between.

    The stepper never exceeds the runner's own hard budget (``cap``):
    once spent reaches it, :attr:`exhausted` is set and stepping ends —
    the caller falls back to the best measured point so far, or to the
    model-predicted plan when nothing was measured
    (docs/pipeline.md §serve). A step that measures nothing new means
    the strategy has converged (:attr:`done`); the final ``executed``
    list is then exactly what one blocking ``search()`` call would have
    returned.
    """

    def __init__(self, strategy, sweep, runner: SearchRunner):
        self.strategy = get_strategy(strategy)
        self.sweep = sweep
        self.runner = runner
        self.cap = runner.budget  # the search's true hard budget
        self.executed: list[ExecutedPoint] = []
        self.done = False
        self.exhausted = False

    def step(self) -> ExecutedPoint | None:
        """Advance by at most one live timing.

        Returns the newly measured point, or ``None`` when the search
        is over (converged or budget-exhausted — check the flags).
        """
        if self.done:
            return None
        spent0 = self.runner.budget_spent
        if self.cap is not None and spent0 >= self.cap:
            self.done = self.exhausted = True
            return None
        self.runner.budget = spent0 + 1
        try:
            self.executed = self.strategy.search(self.sweep, self.runner)
        except BudgetExhausted:  # strategies catch this; belt and braces
            pass
        finally:
            self.runner.budget = self.cap
        if self.runner.budget_spent == spent0:
            # The strategy finished without wanting another timing.
            self.done = True
            return None
        # Parallel trial execution, minimal form (docs/pipeline.md
        # §search): the budget cut-off recorded the candidate the
        # strategy wanted next; warm its compile on idle devices while
        # the caller ticks. measure() joins the warm-up before its timed
        # reps, so measured wall-clock stays per-trial-isolated.
        self.runner.prefetch()
        fresh = [e for e in self.executed if not e.cached]
        return fresh[-1] if fresh else None

    def best(self) -> ExecutedPoint | None:
        """Measured-best executed point so far (None before any timing)."""
        return max(
            self.executed, key=lambda e: e.measured_gflops, default=None,
        )


from .surrogate import TPESearch  # noqa: E402 — registry import, not a cycle

#: CLI / facade registry: ``--strategy`` spellings → constructors.
STRATEGIES = {
    "exhaustive": ExhaustiveSearch,
    "refine": LocalRefine,
    "halving": SuccessiveHalving,
    "tpe": TPESearch,
}


def get_strategy(spec) -> SearchStrategy:
    """Normalize a strategy spec: a name, a class, or an instance."""
    if isinstance(spec, str):
        try:
            return STRATEGIES[spec]()
        except KeyError:
            raise ValueError(
                f"unknown search strategy {spec!r} "
                f"(want one of {sorted(STRATEGIES)})"
            ) from None
    if isinstance(spec, type):
        spec = spec()
    if not isinstance(spec, SearchStrategy):
        raise TypeError(
            f"{spec!r} does not implement SearchStrategy "
            "(needs .name and .search(sweep, runner))"
        )
    return spec
