"""The port's search subsystem against the JAX package's: strategies,
budget accounting, plan dedupe, studies and resume.

Every strategy runs in both packages under a deterministic fake timer
that derives wall times from the analytic model of the legalized plan —
the reference under ``tests/_search_harness.py``'s ``ModelTimer``, the
port under the copy below — so no kernel executes and no host-timing
noise can flake an assertion. The port's model is ``GPUModel`` built
with the reference ``TPUTarget``'s constants, on the 64×64 toy lattice
where every Hopper tile fits, so both packages see the same sweep and
the same walls: the trial sequences (plan keys, in order) and
``budget_spent`` must be equal, exactly.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
from _search_harness import TOY as JTOY
from _search_harness import ModelTimer as JModelTimer
from _search_harness import _rf as _jrf

from repro.core.dse import TPUTarget
from repro.core.explorer import Explorer as JExplorer
from repro.core.search import EXECUTED_POINT_FIELDS as J_EXECUTED_FIELDS
from repro.core.search import SEARCH_RESULT_FIELDS as J_RESULT_FIELDS
from repro.core.search import (
    ExhaustiveSearch as JExhaustive,
)
from repro.core.search import LocalRefine as JRefine
from repro.core.search import SuccessiveHalving as JHalving
from repro.core.search import TPESearch as JTPE
from repro_torch.core.dse import GPUModel, GPUTarget, StreamWorkload
from repro_torch.core.explorer import Explorer
from repro_torch.core.search import (
    EXECUTED_POINT_FIELDS,
    SEARCH_RESULT_FIELDS,
    BudgetExhausted,
    ExhaustiveSearch,
    LocalRefine,
    RunPlan,
    SearchRunner,
    Study,
    SuccessiveHalving,
    TPESearch,
    default_study_dir,
)

H, W = 64, 64
TOY = StreamWorkload("toy", 8, 2, 2, 50, 40_000, H * W, grid_w=W, halo=1)
BH_VALUES = (8, 16, 32, 64)
M_VALUES = (1, 2, 4, 8)


def tpu_constants() -> GPUTarget:
    """A GPUTarget carrying the reference TPUTarget's constants."""
    return GPUTarget(**dataclasses.asdict(TPUTarget()))


# ---- the port's deterministic timer: a copy of tests/_search_harness.py --


def plan_noise(seed: int, key: tuple, scale: float) -> float:
    """Deterministic multiplicative jitter in [1-scale, 1+scale], a pure
    function of (seed, plan key)."""
    if not scale:
        return 1.0
    digest = hashlib.sha256(f"{seed}:{key}".encode("utf-8")).digest()
    u = int.from_bytes(digest[:8], "big") / float(1 << 64)
    return 1.0 + scale * (2.0 * u - 1.0)


class ModelTimer:
    """Wall time from the analytic model of the legalized plan (the port's
    copy of the reference harness's timer)."""

    def __init__(self, workload=TOY, h=H, w=W, boost=(), noise=0.0, seed=0,
                 model=None):
        self.model = model or GPUModel(tpu_constants())
        self.workload, self.h, self.w = workload, h, w
        self.boost = dict(boost)
        self.noise = float(noise)
        self.seed = int(seed)
        self.calls: list[RunPlan] = []

    def __call__(self, plan, run, reps, warmup):
        self.calls.append(plan)
        pred = self.model.evaluate(
            self.workload, plan.block_h, plan.m, d=plan.d,
            double_buffer=plan.double_buffer, b=plan.b,
        ).sustained_gflops
        sites = self.h * self.w * plan.steps * plan.b
        wall = sites * self.workload.flops_per_elem / (pred * 1e9)
        wall *= plan_noise(self.seed, plan.key(), self.noise)
        return wall / self.boost.get((plan.block_h, plan.m, plan.d), 1.0)


def _rf(nsteps, m, block_h, d, double_buffer=True):
    return lambda: None  # never called: the fake timer ignores `run`


def _sweep(ex, **kw):
    kw.setdefault("bh_values", BH_VALUES)
    kw.setdefault("m_values", M_VALUES)
    kw.setdefault("d_values", (1,))
    return (ex.sweep_gpu if isinstance(ex, Explorer) else ex.sweep_tpu)(**kw)


def _port_search(ex, sweep, timer, **kw):
    kw.setdefault("run_factory", _rf)
    kw.setdefault("grid_shape", (H, W))
    kw.setdefault("calibrate", False)
    kw.setdefault("device", "cpu")
    kw.setdefault("max_devices", 4)
    return ex.search(sweep, timer=timer, **kw)


def _jax_search(ex, sweep, timer, **kw):
    kw.setdefault("run_factory", _jrf)
    kw.setdefault("grid_shape", (H, W))
    kw.setdefault("calibrate", False)
    kw.setdefault("max_devices", 4)
    return ex.search(sweep, timer=timer, **kw)


def _keys(plans):
    return [tuple(p.key()) for p in plans]


def _executed(res):
    return [(e.block_h, e.m, e.d, e.steps, e.reps, e.double_buffer, e.cached)
            for e in res.executed]


@pytest.fixture()
def pair():
    port = Explorer(TOY, gpu=GPUModel(tpu_constants()))
    ref = JExplorer(JTOY)
    return port, ref


STRATEGIES = {
    "exhaustive": (lambda: ExhaustiveSearch(frontier_only=False),
                   lambda: JExhaustive(frontier_only=False), None),
    "frontier": (lambda: ExhaustiveSearch(k=3, frontier_only=True),
                 lambda: JExhaustive(k=3, frontier_only=True), None),
    "refine": (lambda: LocalRefine(), lambda: JRefine(), 10),
    "halving": (lambda: SuccessiveHalving(eta=2), lambda: JHalving(eta=2),
                12),
    "tpe": (lambda: TPESearch(seed=0), lambda: JTPE(seed=0), 8),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("d_values", [(1,), (1, 2, 4)])
def test_trial_sequence_and_budget_equal_the_reference(pair, name,
                                                       d_values):
    """Exact: the timed plan keys in order, the executed points and
    ``budget_spent`` of each strategy, under the same timer."""
    port, ref = pair
    make_port, make_ref, budget = STRATEGIES[name]
    pt, jt = ModelTimer(noise=0.05), JModelTimer(noise=0.05)
    got = _port_search(port, _sweep(port, d_values=d_values), pt,
                       strategy=make_port(), budget=budget)
    want = _jax_search(ref, _sweep(ref, d_values=d_values), jt,
                       strategy=make_ref(), budget=budget)
    assert _keys(pt.calls) == _keys(jt.calls)
    assert got.budget_spent == want.budget_spent == len(pt.calls)
    assert _executed(got) == _executed(want)
    assert got.best.measured_gflops == want.best.measured_gflops
    assert got.skipped_devices == want.skipped_devices
    assert got.declined == 0


def test_timer_walls_equal_the_reference_timer():
    plans = [RunPlan(bh, m, m, 1, 3, True, 1, "", 1)
             for bh in BH_VALUES for m in M_VALUES]
    got = [ModelTimer(noise=0.05)(p, None, 3, 1) for p in plans]
    want = [JModelTimer(noise=0.05)(p, None, 3, 1) for p in plans]
    assert got == want


def test_record_schemas():
    """The executed-point schema is the reference's; the search result
    adds ``declined`` after ``skipped_illegal``."""
    assert EXECUTED_POINT_FIELDS == J_EXECUTED_FIELDS
    ref = list(J_RESULT_FIELDS)
    ref.insert(ref.index("skipped_illegal") + 1, "declined")
    assert SEARCH_RESULT_FIELDS == tuple(ref)


def test_budget_is_a_hard_cap_and_schema_holds(pair, tmp_path):
    port, _ = pair
    sweep = _sweep(port)
    for budget in (1, 3, 5):
        t = ModelTimer()
        res = _port_search(port, sweep, t, strategy="halving",
                           budget=budget)
        assert res.budget_spent == len(t.calls) <= budget
    res = _port_search(port, sweep, ModelTimer(), strategy=TPESearch(seed=0),
                       budget=4, study="schema", cache_tag="toy",
                       study_dir=str(tmp_path))
    d = res.as_dict()
    assert tuple(d) == SEARCH_RESULT_FIELDS
    for e in d["executed"]:
        assert tuple(e) == EXECUTED_POINT_FIELDS
        assert e["interpret"] is True  # a CPU run
    with pytest.raises(ValueError):
        _port_search(port, sweep, ModelTimer(), budget=0)


def test_budget_exhausted_raises_before_the_run(pair):
    port, _ = pair
    sweep = _sweep(port)
    runner = SearchRunner(workload=TOY, grid_shape=(H, W), run_factory=_rf,
                          model=port.gpu, device="cpu", calibrate=False,
                          budget=1, timer=ModelTimer())
    pts = sweep.top(2)
    assert runner.measure(pts[0]) is not None
    with pytest.raises(BudgetExhausted):
        runner.measure(pts[1])
    assert runner.last_blocked is pts[1]
    assert runner.max_devices == 1  # a CPU runner: one device
    assert runner.interpret and runner.backend.startswith("cpu/")


def test_resumed_study_measures_zero_and_matches_the_reference(pair,
                                                               tmp_path):
    """Interrupt a budgeted TPE search, resume it by name: every completed
    trial replays, none re-measures — in both packages, with the same
    trials."""
    port, ref = pair
    results = {}
    for pkg, ex, timer, search, tpe in (
            ("port", port, ModelTimer, _port_search, TPESearch),
            ("ref", ref, JModelTimer, _jax_search, JTPE)):
        study_dir = str(tmp_path / pkg)
        sweep = _sweep(ex)
        t1 = timer()
        first = search(ex, sweep, t1, strategy=tpe(seed=0), budget=4,
                       study="resume", cache_tag="toy", study_dir=study_dir)
        n = first.budget_spent
        t2 = timer()
        again = search(ex, sweep, t2, strategy=tpe(seed=0, max_trials=n),
                       budget=4, study="resume", cache_tag="toy",
                       study_dir=study_dir)
        assert again.budget_spent == 0 and not t2.calls
        assert again.replayed == n
        assert sorted(_keys(t1.calls)) == sorted(
            (e.block_h, e.m, e.steps, e.d, e.reps, e.double_buffer, e.b,
             e.fusion, e.dx) for e in again.executed)
        results[pkg] = (_keys(t1.calls), n, again.replayed)
    assert results["port"] == results["ref"]


def test_study_and_cache_default_to_the_ports_own_paths(monkeypatch):
    from repro.core.measure import default_cache_path as jcache
    from repro.core.search import default_study_dir as jstudy
    from repro_torch.core.measure import default_cache_path

    monkeypatch.delenv("REPRO_TORCH_STUDY_DIR", raising=False)
    monkeypatch.delenv("REPRO_TORCH_MEASURE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_STUDY_DIR", "/elsewhere/studies")
    monkeypatch.setenv("REPRO_MEASURE_CACHE", "/elsewhere/cache.json")
    assert default_study_dir() != jstudy()
    assert default_cache_path() != jcache()
    assert default_study_dir().endswith("build/repro_torch/studies")
    monkeypatch.setenv("REPRO_TORCH_STUDY_DIR", "/mine")
    assert default_study_dir() == "/mine"
    assert isinstance(Study("ok", "/nonexistent-dir-for-test"), Study)


def test_cpu_and_card_records_never_alias(pair, tmp_path):
    """A CPU runner's cache keys carry ``interpret`` true and a ``cpu/``
    backend, so its walls can never serve a card run."""
    port, _ = pair
    cpu = SearchRunner(workload=TOY, grid_shape=(H, W), run_factory=_rf,
                       device="cpu", fingerprint="spd:x", calibrate=False)
    plan = RunPlan(16, 4, 4, 1, 3, True, 1, "", 1)
    key_cpu = cpu.cache_key(plan)
    from repro_torch.core.measure import MeasurementCache

    key_card = MeasurementCache.make_key(
        "spd:x", (H, W), (16, 4, 4, 1, 1), "cuda/NVIDIA H100 80GB HBM3",
        False, 3, 1)
    assert key_cpu != key_card


def test_declined_plans_are_counted_not_raised(pair):
    """A back end that cannot launch a plan declines it; the search goes
    on and counts it."""
    port, _ = pair
    sweep = _sweep(port)

    def picky(nsteps, m, block_h, d, double_buffer=True):
        return None if m == 8 else (lambda: None)

    t = ModelTimer()
    res = _port_search(port, sweep, t, run_factory=picky,
                       strategy=ExhaustiveSearch(frontier_only=False))
    assert res.declined == sum(1 for p in sweep.top(len(sweep))
                               if p.m == 8)
    assert all(e.m != 8 for e in res.executed)
    assert len(res.executed) == len(t.calls) == res.budget_spent


def test_prefetch_warms_on_a_thread_and_joins_before_timing(pair):
    """The next candidate's warm-up runs on a background thread (which
    sets its own current CUDA device for a card run); measure() joins it
    before any timed rep."""
    port, _ = pair
    sweep = _sweep(port)
    order = []

    def rf(nsteps, m, block_h, d, double_buffer=True):
        return lambda: order.append(("run", block_h, m, d)) or torch.zeros(1)

    def timer(plan, run, reps, warmup):
        order.append(("timed", plan.block_h, plan.m, plan.d))
        return 1e-3

    runner = SearchRunner(workload=TOY, grid_shape=(H, W), run_factory=rf,
                          model=port.gpu, device="cpu", calibrate=False,
                          timer=timer, max_devices=2)
    pt = sweep.top(1)[0]
    assert runner.prefetch(pt)
    assert runner.prefetched == 1
    runner.measure(sweep.top(2)[1])
    assert runner._prefetch is None  # joined before the timed rep
    plan = runner.plan_for(pt)
    assert order.index(("run", plan.block_h, plan.m, plan.d)) < \
        [i for i, o in enumerate(order) if o[0] == "timed"][0]


def test_search_runs_the_plain_kernel_and_dedupes(tmp_path):
    """End to end on the CPU: the generated diffusion kernel's plain
    version through a real (host-timed) search; a repeat is served from
    the cache and spends nothing. Only counts are asserted."""
    from repro_torch.apps import diffusion as dif

    sim = dif.DiffusionSimulation(32, 32, device="cpu")
    ex = sim.explorer()
    sweep = ex.sweep_gpu(bh_values=(8, 16), m_values=(1, 2), d_values=(1,))
    u0, _ = dif.sine_init(32, 32, device="cpu")
    cache = str(tmp_path / "mc.json")
    first = ex.search(sweep, sim.state(u0), (0.2,), strategy="halving",
                      budget=3, reps=1, calibrate=False, cache=cache)
    assert 0 < first.budget_spent <= 3
    again = ex.search(sweep, sim.state(u0), (0.2,), strategy="halving",
                      budget=3, reps=1, calibrate=False, cache=cache)
    assert again.budget_spent == 0
    assert [e.cached for e in again.executed] == [True] * len(again.executed)
    assert all(e.interpret and np.isfinite(e.measured_gflops)
               for e in first.executed)
