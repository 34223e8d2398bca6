"""Mesh planner: the paper's (spatial x temporal) trade lifted to LM fleets.

A copy of the JAX package's ``core/planner.py`` (framework-free), so
``python -m repro_torch.cli explore`` section 4 prints the reference's
plan table (``tests/test_torch_cli.py``).

The correspondence implemented here (DESIGN.md §4):

* spatial parallelism (duplicate pipelines, n) -> **data parallelism**:
  throughput scales with dp but so does the "external bandwidth" demand —
  the per-step gradient all-reduce.
* temporal parallelism (cascade PEs, m) -> **pipeline parallelism**: layer
  groups cascade; no extra gradient traffic, but on-chip (HBM) footprint
  redistributes and the fill/drain bubble ``(S-1)/(M+S-1)`` appears, exactly
  the paper's prologue/epilogue utilization loss.
* in-pipeline fine-grained parallelism -> **tensor parallelism** inside a
  stage (the operators of one formula node).

``plan()`` enumerates (dp, tp, pp) factorizations of a chip count and ranks
them with the same three-term roofline used everywhere else in this repo.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class ArchStats:
    """Minimal per-architecture numbers the planner needs."""

    name: str
    params: float  # total parameters
    active_params: float  # per-token active parameters (MoE < total)
    n_layers: int
    d_model: int
    global_batch: int
    seq_len: int
    dtype_bytes: int = 2  # bf16


@dataclass(frozen=True)
class PlannerTarget:
    """Per-chip fleet constants. The defaults are the JAX package's (its
    TPU fleet), kept so the ranking is the reference's plan for plan; they
    are not an H100's (an H100 fleet target waits for the LM substrate's
    port)."""

    peak_tflops: float = 197.0  # bf16 / chip
    hbm_gbs: float = 819.0
    ici_gbs: float = 50.0  # per link
    hbm_bytes: float = 16 * 2**30
    opt_state_bytes_per_param: float = 8.0  # adam m+v fp32


@dataclass
class MeshPlan:
    dp: int
    tp: int
    pp: int
    microbatches: int
    feasible: bool = True
    limits: list[str] = field(default_factory=list)
    step_time_s: float = 0.0
    t_compute: float = 0.0
    t_dp_allreduce: float = 0.0
    t_tp_collective: float = 0.0
    pipeline_util: float = 1.0
    hbm_per_chip: float = 0.0

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pp


def _divisors(x: int) -> list[int]:
    return [d for d in range(1, x + 1) if x % d == 0]


def evaluate_plan(
    a: ArchStats,
    dp: int,
    tp: int,
    pp: int,
    target: PlannerTarget = PlannerTarget(),
    microbatches: int | None = None,
    training: bool = True,
) -> MeshPlan:
    chips = dp * tp * pp
    mb = microbatches or max(4 * pp, 1)
    plan = MeshPlan(dp=dp, tp=tp, pp=pp, microbatches=mb)

    tokens = a.global_batch * a.seq_len
    flops = (6.0 if training else 2.0) * a.active_params * tokens
    plan.t_compute = flops / (chips * target.peak_tflops * 1e12)

    # Spatial cost: ring all-reduce of gradients across dp (bf16 grads).
    grad_bytes = a.params / (tp * pp) * a.dtype_bytes
    plan.t_dp_allreduce = (
        2.0 * grad_bytes * (dp - 1) / dp / (target.ici_gbs * 1e9)
        if (dp > 1 and training)
        else 0.0
    )
    # TP: ~4 activation collectives per layer (fwd+bwd all-reduce pair).
    act_bytes = (
        tokens / dp * a.d_model * a.dtype_bytes / max(tp, 1)
    )
    plan.t_tp_collective = (
        4.0 * a.n_layers * act_bytes * (tp - 1) / tp / (target.ici_gbs * 1e9)
        if tp > 1
        else 0.0
    )
    # Temporal cost: the pipeline fill/drain bubble (paper's u_pipe).
    plan.pipeline_util = mb / (mb + pp - 1) if pp > 1 else 1.0

    compute_and_tp = (plan.t_compute + plan.t_tp_collective) / plan.pipeline_util
    # DP all-reduce overlaps the backward pass; it binds only if longer.
    plan.step_time_s = max(compute_and_tp, plan.t_dp_allreduce)

    # Memory feasibility: weights + optimizer states + activations/microbatch.
    wpc = a.params * a.dtype_bytes / (tp * pp)
    opt = a.params * target.opt_state_bytes_per_param / (tp * pp * dp)
    act = tokens / dp / mb * a.d_model * a.dtype_bytes * 8 / tp
    plan.hbm_per_chip = wpc + (opt if training else 0.0) + act
    if plan.hbm_per_chip > target.hbm_bytes:
        plan.feasible = False
        plan.limits.append(
            f"HBM {plan.hbm_per_chip/2**30:.1f}GiB>{target.hbm_bytes/2**30:.0f}GiB"
        )
    if a.global_batch % dp != 0:
        plan.feasible = False
        plan.limits.append("batch%dp")
    if pp > a.n_layers:
        plan.feasible = False
        plan.limits.append("pp>layers")
    dominant = max(
        ("compute", plan.t_compute),
        ("dp-allreduce", plan.t_dp_allreduce),
        ("tp-collective", plan.t_tp_collective),
        key=lambda kv: kv[1],
    )[0]
    if plan.pipeline_util < 0.9 and pp > 1:
        plan.limits.append(f"bubble={1-plan.pipeline_util:.2f}")
    plan.limits.append(f"{dominant}-bound")
    return plan


def plan(
    a: ArchStats,
    chips: int,
    target: PlannerTarget = PlannerTarget(),
    tp_max: int = 16,
    training: bool = True,
) -> list[MeshPlan]:
    """Enumerate and rank mesh factorizations for ``chips`` devices."""
    plans: list[MeshPlan] = []
    for tp in _divisors(chips):
        if tp > tp_max:
            continue
        rest = chips // tp
        for pp in _divisors(rest):
            dp = rest // pp
            plans.append(evaluate_plan(a, dp, tp, pp, target, training=training))
    return sorted(plans, key=lambda p: (not p.feasible, p.step_time_s))


def render_plans(plans: Sequence[MeshPlan], top: int = 10) -> str:
    head = (
        "| dp | tp | pp | mb | feasible | step s | compute s | dp-AR s | tp s "
        "| bubble | HBM/chip GiB | notes |\n|--|--|--|--|--|--|--|--|--|--|--|--|"
    )
    rows = [
        f"| {p.dp} | {p.tp} | {p.pp} | {p.microbatches} | "
        f"{'y' if p.feasible else 'N'} | {p.step_time_s:.4f} | "
        f"{p.t_compute:.4f} | {p.t_dp_allreduce:.4f} | {p.t_tp_collective:.4f} | "
        f"{1-p.pipeline_util:.3f} | {p.hbm_per_chip/2**30:.2f} | "
        f"{';'.join(p.limits)} |"
        for p in plans[:top]
    ]
    return "\n".join([head] + rows)
