"""Pluggable, budgeted design-space search (docs/pipeline.md §search).

The port of the JAX package's ``core/search`` (docs/port.md §dse): a
:class:`~repro_torch.core.search.strategies.SearchStrategy` decides which
(n, m, d, block_h) candidates to spend measurements on, and the
:class:`~repro_torch.core.search.runner.SearchRunner` is the single
legalize→run→time→calibrate engine every strategy shares — one plan
dedupe table, one calibration anchor set, one measurement cache, one
hard budget. :class:`SearchResult` is what a search returns: the
executed points plus the accounting (strategy name, budget spent,
per-plan measurement counts, declined plans) that ``python -m
repro_torch.cli explore --json`` records. Durable, resumable searches
layer on top: :class:`~repro_torch.core.search.study.Study` journals
every trial and :class:`~repro_torch.core.search.surrogate.TPESearch`
learns where to measure next from them (docs/pipeline.md §study).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .runner import (
    EXECUTED_POINT_FIELDS,
    PLAN_FIELDS,
    BudgetExhausted,
    ExecutedPoint,
    RunPlan,
    SearchRunner,
    kernel_run_factory,
)
from .strategies import (
    STRATEGIES,
    ExhaustiveSearch,
    LocalRefine,
    SearchStepper,
    SearchStrategy,
    SuccessiveHalving,
    get_strategy,
)
from .study import Study, default_study_dir
from .surrogate import TPESearch

__all__ = [
    "BudgetExhausted",
    "EXECUTED_POINT_FIELDS",
    "ExecutedPoint",
    "ExhaustiveSearch",
    "LocalRefine",
    "PLAN_FIELDS",
    "RunPlan",
    "SEARCH_RESULT_FIELDS",
    "STRATEGIES",
    "SearchResult",
    "SearchRunner",
    "SearchStepper",
    "SearchStrategy",
    "Study",
    "SuccessiveHalving",
    "TPESearch",
    "default_study_dir",
    "get_strategy",
    "kernel_run_factory",
]


#: The one search-result record schema: ``SearchResult.as_dict`` (the
#: CLI ``--json`` report) carries exactly these keys — the reference's,
#: plus ``declined``.
SEARCH_RESULT_FIELDS = (
    "strategy",
    "budget",
    "budget_spent",
    "measurements",
    "skipped_devices",
    "skipped_illegal",
    "declined",
    "study",
    "replayed",
    "best",
    "executed",
)


@dataclass
class SearchResult:
    """One search invocation: executed points + budget accounting.

    ``executed`` is in measurement order (what the strategy did);
    ``best`` ranks by *measured* GFLOPS — the search's answer.
    ``budget_spent`` counts live timings only: cache and in-run dedupe
    hits are free, so a repeated search reports 0 spent.
    ``declined`` counts legal plans the back end could not launch
    (docs/port.md §dse). ``measurements`` is the per-candidate ledger — one record per
    concrete plan timed live, with its count (successive halving times
    a surviving plan once per rung, at increasing reps).
    """

    strategy: str
    executed: list[ExecutedPoint] = field(default_factory=list)
    budget: int | None = None
    budget_spent: int = 0
    measurements: list[dict] = field(default_factory=list)
    skipped_devices: int = 0
    skipped_illegal: int = 0
    declined: int = 0  # legal plans the back end could not launch
    study: str | None = None  # durable study this search journaled into
    replayed: int = 0  # completed trials replayed from it (0 budget each)

    @property
    def best(self) -> ExecutedPoint | None:
        """The measured-best *finalist* (None when nothing ran).

        Only measurements at the highest rep count present compete:
        under a rung schedule (successive halving) those are the
        full-rep finals, so neither a plan's own lucky 1-rep screening
        number nor an eliminated candidate's inflated screening wall
        can outrank an honest final. For single-rep-level strategies
        (exhaustive, refine) this is simply the measured argmax.
        """
        if not self.executed:
            return None
        max_reps = max(e.reps for e in self.executed)
        finalists = [e for e in self.executed if e.reps == max_reps]
        return max(finalists, key=lambda e: e.measured_gflops)

    def __len__(self) -> int:
        return len(self.executed)

    def as_dict(self) -> dict:
        """JSON-ready record — the one serialization
        (:data:`SEARCH_RESULT_FIELDS`) of the CLI's ``--json`` report."""
        best = self.best
        return {
            "strategy": self.strategy,
            "budget": None if self.budget is None else int(self.budget),
            "budget_spent": int(self.budget_spent),
            "measurements": list(self.measurements),
            "skipped_devices": int(self.skipped_devices),
            "skipped_illegal": int(self.skipped_illegal),
            "declined": int(self.declined),
            "study": self.study,
            "replayed": int(self.replayed),
            "best": None if best is None else best.as_dict(),
            "executed": [e.as_dict() for e in self.executed],
        }
