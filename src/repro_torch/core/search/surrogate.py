"""Surrogate-model search: Tree-structured Parzen Estimator (TPE).

A copy of the JAX package's ``core/search/surrogate.py`` (framework-free;
docs/port.md §dse), held to it by ``tests/test_torch_search.py``.

The hand-rolled strategies in ``strategies.py`` spend budget in fixed
patterns (walk the frontier, hill-climb, race rungs). :class:`TPESearch`
instead *learns where to measure next* from the measurements themselves
— the Optuna-style sampler the DSE harness in SNIPPETS.md builds its
studies on, specialized to the (n, m, d, block_h) lattice
(docs/pipeline.md §study, DESIGN.md §11):

* observed trials are split into **good** (top ``gamma`` quantile by
  measured GFLOP/s) and **bad** (the rest); two Parzen windows
  ``l(x)`` / ``g(x)`` — Gaussian kernels over the log2 coordinates —
  density-model each side, and the next candidate is the unmeasured one
  maximizing ``l(x)/g(x)``: likely-good, unlike-bad;
* **legalizer infeasibility is a continuous penalty**, not a hard
  reject: a candidate with no legal run plan is observed at its
  :func:`~repro_torch.core.legalize.constraint_violation` distance and always
  classified *bad* — the sampler learns a gradient away from the
  infeasible region without spending a single measurement on it (the
  ``constraint_violation``-as-gradient idiom);
* the sampler **warm-starts from prior knowledge**: plans the attached
  :class:`~repro_torch.core.search.study.Study` replayed into the runner's
  dedupe table and plans already in the persistent
  :class:`~repro_torch.core.measure.MeasurementCache` for the same core
  fingerprint are observed first, for free — a resumed study continues
  where it stopped with zero re-measurement;
* every random draw comes from one ``numpy`` generator seeded with
  ``seed``, and every ranking uses stable order (model-best first), so
  a seeded search is **reproducible trial-for-trial** — the property
  the deterministic harness in ``tests/test_study.py`` asserts.

``max_trials`` bounds *observations* (measured + warm-started +
violations), while the runner's ``budget`` bounds live measurements;
a resumed study whose replayed trials already cover ``max_trials``
therefore spends zero budget.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..legalize import constraint_violation
from .runner import BudgetExhausted, ExecutedPoint, SearchRunner

__all__ = ["TPESearch"]


@dataclass(eq=False)  # identity equality: ndarray fields don't compare
class _Candidate:
    """One deduplicated lattice candidate the sampler can pick."""

    point: object  # the DesignPoint this candidate measures
    coords: tuple  # (block_h, m, d) — legalized when a plan exists
    x: np.ndarray  # log2 feature vector the Parzen windows model
    plan: object  # legalized RunPlan; None = infeasible (violation > 0)
    violation: float  # constraint_violation distance (0.0 = legal)
    model_gflops: float


@dataclass
class TPESearch:
    """Tree-structured Parzen Estimator over the (n, m, d, block_h) lattice.

    Parameters mirror the classic TPE knobs: ``n_startup`` observations
    are taken before density modeling starts (model-best first, then a
    seeded random permutation — exploration the model cannot bias);
    ``gamma`` is the good-quantile; ``bandwidth`` the Gaussian kernel
    width in log2 lattice units; ``prior_weight`` a uniform pseudo-count
    that keeps fresh densities from collapsing onto the first
    observations.
    """

    name: str = field(default="tpe", init=False)
    seed: int = 0
    n_startup: int = 4
    gamma: float = 0.25
    bandwidth: float = 0.75
    prior_weight: float = 1.0
    max_trials: int | None = None

    # ---- candidate pool ----------------------------------------------------

    def _candidates(self, sweep, runner: SearchRunner) -> list[_Candidate]:
        """The full lattice, model-best first, deduped, violations kept.

        Unlike ``_ranked_candidates`` this does *not* drop candidates
        without a legal plan: they become zero-cost violation
        observations that teach the sampler the feasible region's shape.
        Device-starved coordinates are dropped (no amount of sampling
        makes more chips appear).
        """
        gflops = np.asarray(sweep.data["sustained_gflops"], float)
        order = np.argsort(-gflops, kind="stable")
        seen_coords: set = set()
        seen_plans: set = set()
        out: list[_Candidate] = []
        for i in order:
            i = int(i)
            bh = int(sweep.data["block_rows"][i])
            m = int(sweep.data["m"][i])
            d = max(1, int(sweep.data["n"][i]))
            b = (int(sweep.data["b"][i]) if "b" in sweep.data else 1)
            fus = (str(sweep.data["fusion"][i])
                   if "fusion" in sweep.data else "")
            dxv = (max(1, int(sweep.data["dx"][i]))
                   if "dx" in sweep.data else 1)
            # Candidate coords stay numeric (the study journals them as
            # ints); the fusion spec joins the dedupe key separately.
            # The mesh axis joins only when column-sharded (DESIGN.md
            # §15), keeping pre-mesh coords — and old study violation
            # records — byte-identical.
            coords = (bh, m, d, b) if dxv == 1 else (bh, m, d, b, dxv)
            if coords + (fus,) in seen_coords:
                continue
            seen_coords.add(coords + (fus,))
            if d > runner.max_devices:
                runner.skipped_devices += 1
                continue
            pt = sweep.point(i)
            req_db = bool(
                (getattr(pt, "detail", None) or {}).get("double_buffer", True)
            )
            plan = runner.plan_for(pt)
            if plan is None:
                viol = constraint_violation(
                    runner.h, bh, m, halo=runner.halo, width=runner.width,
                    words=runner.words, d=d, double_buffer=req_db, b=b,
                    dx=dxv, halo_x=runner.halo_x,
                )
                out.append(_Candidate(
                    point=pt, coords=coords,
                    x=self._features(bh, m, d, req_db, b, fus, dxv),
                    plan=None, violation=max(viol, 1e-9),
                    model_gflops=float(gflops[i]),
                ))
                continue
            pkey = (plan.block_h, plan.m, plan.steps, plan.d,
                    plan.double_buffer, plan.b, plan.fusion, plan.dx)
            if pkey in seen_plans:
                continue  # same concrete plan: model-best spelling wins
            seen_plans.add(pkey)
            out.append(_Candidate(
                point=pt,
                coords=(
                    (plan.block_h, plan.m, plan.d, plan.b)
                    if plan.dx == 1
                    else (plan.block_h, plan.m, plan.d, plan.b, plan.dx)
                ),
                x=self._features(plan.block_h, plan.m, plan.d,
                                 plan.double_buffer, plan.b, plan.fusion,
                                 plan.dx),
                plan=plan, violation=0.0,
                model_gflops=float(gflops[i]),
            ))
        return out

    @staticmethod
    def _features(bh: int, m: int, d: int,
                  double_buffer: bool = True, b: int = 1,
                  fusion: str = "", dx: int = 1) -> np.ndarray:
        """Log2 lattice coordinates plus the binary buffer-protocol axis:
        the natural metric of a power-of-two sweep (one halving/doubling
        = one unit in every dimension; a double_buffer flip likewise,
        docs/pipeline.md §stream). The batch axis b joins in log2 too
        (docs/pipeline.md §serve), and a program's fusion partition
        (docs/pipeline.md §program) contributes its cluster count in
        log2 — finer partitions are farther from fully fused, and
        single-core plans ("" = one cluster) sit at the legacy origin.
        The mesh column axis dx (DESIGN.md §15) joins in log2 as well;
        ring plans (dx = 1) contribute 0, so pre-mesh sweeps keep their
        pairwise distances — and their seeded sampling order — exactly."""
        nclusters = fusion.count("+") + 1 if fusion else 1
        return np.array(
            [math.log2(max(1, bh)), math.log2(max(1, m)),
             math.log2(max(1, d)), float(bool(double_buffer)),
             math.log2(max(1, b)), math.log2(max(1, nclusters)),
             math.log2(max(1, dx))], float,
        )

    # ---- density model -----------------------------------------------------

    def _density(self, x: np.ndarray, obs: list[np.ndarray]) -> float:
        """Parzen window with a uniform prior pseudo-count."""
        k = 0.0
        for xo in obs:
            diff = x - xo
            k += math.exp(-float(diff @ diff) / (2.0 * self.bandwidth ** 2))
        return (self.prior_weight * 1.0 + k) / (self.prior_weight + len(obs))

    def _pick(self, pool: list[_Candidate],
              good: list[np.ndarray], bad: list[np.ndarray]) -> _Candidate:
        """argmax l(x)/g(x); ties resolve to the model-best candidate
        (the pool is model-ranked, and argmax keeps the first max)."""
        scores = np.array([
            self._density(c.x, good) / max(self._density(c.x, bad), 1e-12)
            for c in pool
        ])
        return pool[int(np.argmax(scores))]

    # ---- the strategy ------------------------------------------------------

    def search(self, sweep, runner: SearchRunner) -> list[ExecutedPoint]:
        rng = np.random.default_rng(self.seed)
        pool = self._candidates(sweep, runner)
        out: list[ExecutedPoint] = []
        good_obs: list[tuple[float, np.ndarray]] = []  # (gflops, x) feasible
        bad_x: list[np.ndarray] = []  # violation observations (always bad)
        trials = 0

        def room() -> bool:
            return self.max_trials is None or trials < self.max_trials

        def observe(c: _Candidate) -> ExecutedPoint | None:
            nonlocal trials
            trials += 1
            if c.plan is None:
                bad_x.append(c.x)
                runner.log_violation(c.coords, c.violation)
                return None
            e = runner.measure(c.point)
            if e is None:
                return None
            good_obs.append((e.measured_gflops, c.x))
            out.append(e)
            return e

        # Phase 0 — warm start: anything the study replayed or the
        # persistent cache already holds is observed for free, and
        # counts toward max_trials (that is what makes a fully-replayed
        # resume spend zero budget).
        remaining: list[_Candidate] = []
        for c in pool:
            if (c.plan is not None and room()
                    and runner.peek_wall(c.plan) is not None):
                observe(c)
            else:
                remaining.append(c)

        # Phase 1 — startup: the model's best first, then a seeded
        # permutation of the rest, until n_startup total observations.
        if remaining and room() and trials < self.n_startup:
            startup = [remaining[0]]
            rest = remaining[1:]
            if rest:
                startup.extend(
                    rest[int(j)] for j in rng.permutation(len(rest))
                )
            taken: list[_Candidate] = []
            try:
                for c in startup:
                    if not room() or trials >= self.n_startup:
                        break
                    observe(c)
                    taken.append(c)
            except BudgetExhausted:
                return out
            remaining = [c for c in remaining if c not in taken]

        # Phase 2 — TPE: split observations good/bad, model densities,
        # measure the argmax of l/g, repeat.
        try:
            while remaining and room():
                if good_obs:
                    ranked = sorted(good_obs, key=lambda t: -t[0])
                    n_good = max(1, math.ceil(self.gamma * len(ranked)))
                    good = [x for _, x in ranked[:n_good]]
                    bad = [x for _, x in ranked[n_good:]] + bad_x
                else:
                    good, bad = [], bad_x
                c = self._pick(remaining, good, bad)
                remaining.remove(c)
                observe(c)
        except BudgetExhausted:
            pass
        return out
