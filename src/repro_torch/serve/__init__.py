"""Serving substrate: ``engine`` serves LM decode (continuous batching over
a fixed-slot KV cache); ``sim`` serves stream simulations (a multi-tenant
engine stacking requests along the batch axis of the generated kernels,
docs/port.md §serve)."""

from .sim import (
    PlanResolver,
    SimCompletion,
    SimEngine,
    SimPlan,
    SimRequest,
    TrialContext,
    TuningSession,
    _Active,
    _Cohort,
    _Group,
)

__all__ = [
    "PlanResolver",
    "SimCompletion",
    "SimEngine",
    "SimPlan",
    "SimRequest",
    "TrialContext",
    "TuningSession",
]
