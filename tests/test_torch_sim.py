"""The port's batch axis and simulation-serving engine on the CPU, against
the JAX package's.

Inputs are made with numpy from a seed and handed to both packages, at the
32×32 / 64×64 sizes of ``tests/test_serve_sim.py``. A ``(B, P, H, W)``
batch through the port's launches must give every member bitwise what
its own ``(P, H, W)`` run gives (the plain versions run here), and match
the JAX package's 4-D launches in interpret mode within rtol 2e-5 / atol
1e-6 (XLA and torch contract mul-adds differently). The engine tests are
``tests/test_serve_sim.py``'s, carried over one by one; the port's
completions must match the JAX engine's for the same requests within the
same tolerance (the two models may pin other plans, and the result of N
steps does not depend on the plan). No test asserts a host-timed rate.
"""

import hashlib

import numpy as np
import pytest
import torch

from repro.apps import diffusion as jdif
from repro.apps import lbm as jlbm
from repro_torch.apps import diffusion as tdif
from repro_torch.apps import lbm as tlbm
from repro_torch.kernels.spd_stream.spd_stream import (
    spd_multistep,
    spd_multistep_plain,
)
from repro_torch.kernels.spd_stream.streaming import spd_multistep_streamed
from repro_torch.serve import sim as tsim_mod
from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

RTOL, ATOL = 2e-5, 1e-6
STEPS = 8
TGV_REGS = (1 / 0.8, 0.0, 1.0)


def _dif_members(b, h=32, w=32, seed=0):
    """b numpy (1, H, W) diffusion states: the sine mode plus seeded
    noise."""
    u0 = np.asarray(jdif.sine_init(h, w)[0], np.float32)
    rng = np.random.default_rng(seed)
    return [(u0 + 0.01 * rng.standard_normal((h, w)).astype(np.float32))[None]
            for _ in range(b)]


def _lbm_members(b, h=32, w=32, seed=0):
    """b numpy (10, H, W) uLBM states: TGV populations scaled by seeded
    noise, the attribute plane as is."""
    f, attr, _ = jlbm.taylor_green_init(h, w)
    f, attr = np.asarray(f, np.float32), np.asarray(attr, np.float32)
    rng = np.random.default_rng(seed)
    return [np.concatenate([
        f * (1 + 0.001 * rng.standard_normal(f.shape).astype(np.float32)),
        attr[None]]) for _ in range(b)]


@pytest.fixture(scope="module")
def kernels():
    """Port and JAX kernels of both apps at 32×32: ``{app: (port, jax,
    regs)}``."""
    return {
        "diffusion": (
            tdif.DiffusionSimulation(32, 32, alpha=0.2, device="cpu").kernel,
            jdif.DiffusionSimulation(32, 32, alpha=0.2).kernel, (0.2,)),
        "ulbm": (
            tlbm.LBMSimulation(tlbm.LBMProblem(32, 32), device="cpu")
            .stream_kernel(),
            jlbm.LBMSimulation(jlbm.LBMProblem(32, 32)).stream_kernel(),
            TGV_REGS),
    }


def _members(app, b, seed=0):
    return (_dif_members if app == "diffusion" else _lbm_members)(b,
                                                                  seed=seed)


# ---------------------------- the batch axis ----------------------------


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("app", ["diffusion", "ulbm"])
def test_batched_members_equal_their_own_runs(kernels, app, b):
    """A (B, P, H, W) batch through ``__call__``, ``multistep``,
    ``run_blocked`` and ``run_for_point``: each member bitwise its own
    3-D run (the plain versions), one count per batched launch."""
    kern = kernels[app][0]
    regs = kernels[app][2]
    members = [torch.from_numpy(s) for s in _members(app, b)]
    batch = kern.pack_batch(members)

    class Point:
        m, detail = 2, {"block_rows": 8}

    n = spd_multistep_streamed.launches, spd_multistep.launches
    runs = {
        "call": (kern(batch, regs, m=2, block_h=8),
                 lambda s: kern(s, regs, m=2, block_h=8)),
        "multistep": (kern.multistep(batch, regs, m=4, block_h=8),
                      lambda s: kern.multistep(s, regs, m=4, block_h=8)),
    }
    # the CPU path counts nothing: counts are the card's launches
    assert (spd_multistep_streamed.launches, spd_multistep.launches) == n
    runs["run_blocked"] = (
        kern.run_blocked(batch, regs, steps=STEPS, m=4, block_h=16,
                         double_buffer=False),
        lambda s: kern.run_blocked(s, regs, steps=STEPS, m=4, block_h=16,
                                   double_buffer=False))
    got, plan = kern.run_for_point(batch, regs, point=Point(), steps=STEPS)
    runs["run_for_point"] = (got, lambda s: kern.run_for_point(
        s, regs, point=Point(), steps=STEPS)[0])
    assert plan == (8, 2, True)
    for name, (out, alone) in runs.items():
        assert out.shape == batch.shape, name
        for i, s in enumerate(members):
            assert torch.equal(out[i], alone(s)), (name, i)
    want = spd_multistep_plain(kern.program, batch, regs, m=2, block_h=8,
                               block_w=32)
    assert torch.equal(runs["call"][0], want)
    assert torch.equal(batch, kern.pack_batch(members))  # input untouched


@pytest.mark.parametrize("launch", ["streamed", "declarative"])
@pytest.mark.parametrize("app", ["diffusion", "ulbm"])
def test_batched_launches_match_jax_interpret(kernels, app, launch):
    """Each member of the port's batched launch against the JAX package's
    4-D ``spd_multistep_streamed`` / ``spd_multistep`` in interpret
    mode."""
    from repro.kernels.spd_stream.spd_stream import (
        spd_multistep as jspd_multistep,
    )

    kern, jkern, regs = kernels[app]
    members = _members(app, 2, seed=3)
    stacked = np.stack(members)
    if launch == "streamed":
        got = kern(torch.from_numpy(stacked), regs, m=2, block_h=8)
        want = jkern(stacked, regs, m=2, block_h=8, interpret=True)
    else:
        got = kern.multistep(torch.from_numpy(stacked), regs, m=2,
                             block_h=8)
        want = jspd_multistep(jkern._step_fn, stacked, jkern._scal(regs),
                              m=2, block_h=8, halo=jkern.halo,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------- the engine -----------------------------


def _diffusion_tenant(h=32, w=32, alpha=0.2):
    """(kernel, per-member numpy state factory, regs) for a diffusion
    tenant."""
    sim = tdif.DiffusionSimulation(h, w, alpha=alpha, device="cpu")
    u0 = np.asarray(jdif.sine_init(h, w)[0], np.float32)
    return (sim.kernel, lambda i: (u0 * (1.0 + 0.01 * i))[None],
            (sim.alpha,))


def _lbm_tenant(h=32, w=32):
    sim = tlbm.LBMSimulation(tlbm.LBMProblem(h, w, mode="wrap"),
                             device="cpu")
    f, attr, _ = jlbm.taylor_green_init(h, w)
    f, attr = np.asarray(f, np.float32), np.asarray(attr, np.float32)
    return (sim.stream_kernel(),
            lambda i: np.concatenate([f * (1.0 + 0.01 * i), attr[None]]),
            sim.stream_regs())


def _resolver(study_dir=None, **kw) -> PlanResolver:
    """Small-lattice resolver; ``budget=0`` (the default here) pins the
    model's plan without a single live timing."""
    kw.setdefault("budget", 0)
    kw.setdefault("b_values", (1, 2, 4))
    kw.setdefault("bh_values", (8, 16, 32))
    kw.setdefault("m_values", (1, 2, 4))
    if study_dir is not None:
        kw.setdefault("study_dir", str(study_dir))
    return PlanResolver(**kw)


def _engine(resolver=None, **kw) -> SimEngine:
    return SimEngine(resolver or _resolver(), device="cpu", **kw)


class KeyTimer:
    """Deterministic fake timer: a wall that is a pure function of the
    plan's key, so a replayed study pins exactly the plan it measured."""

    def __init__(self):
        self.calls = []

    def __call__(self, plan, run, reps, warmup):
        self.calls.append(plan)
        digest = hashlib.sha256(repr(plan.key()).encode()).digest()
        return 1e-3 * (1.0 + int.from_bytes(digest[:4], "big") / 2 ** 32)


def test_submit_rejects_with_backpressure_when_queue_full():
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(max_queue=2)
    reqs = [SimRequest(rid=i, core=kern, state=mk(i), steps=STEPS,
                       regs=regs) for i in range(4)]
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    # queue full: rejected, counted, never silently dropped
    assert not eng.submit(reqs[2]) and not eng.submit(reqs[3])
    assert eng.rejected == 2 and eng.submitted == 2
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == [0, 1]
    stats = eng.stats()
    assert stats["completed"] == stats["submitted"] == 2


def test_drain_returns_every_accepted_request():
    kern, mk, regs = _diffusion_tenant()
    eng = _engine()
    for i in range(5):
        assert eng.submit(SimRequest(rid=i, core=kern, state=mk(i),
                                     steps=STEPS, regs=regs))
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == list(range(5))
    assert all(c.steps == STEPS and isinstance(c.state, np.ndarray)
               for c in done)
    assert eng._active_count() == 0 and not eng.queue


def test_run_until_drained_raises_instead_of_truncating():
    kern, mk, regs = _diffusion_tenant()
    # m=1 forces one fused step per tick: 8 steps cannot drain in 2.
    eng = _engine(_resolver(m_values=(1,)))
    eng.submit(SimRequest(rid=7, core=kern, state=mk(0), steps=STEPS,
                          regs=regs))
    with pytest.raises(RuntimeError, match=r"undrained.*\[7\]"):
        eng.run_until_drained(max_ticks=2)


def test_only_identical_contexts_share_a_launch():
    """Same core fingerprint + grid but different Append_Reg values must
    never stack into one launch (one register vector per launch)."""
    ka, mka, ra = _diffusion_tenant(alpha=0.2)
    kb, mkb, rb = _diffusion_tenant(alpha=0.05)
    eng = _engine()
    for rid, (k, mk, r) in enumerate([(ka, mka, ra), (ka, mka, ra),
                                      (kb, mkb, rb), (kb, mkb, rb)]):
        eng.submit(SimRequest(rid=rid, core=k, state=mk(0), steps=STEPS,
                              regs=r))
    done = {c.rid: c for c in eng.run_until_drained()}
    assert len(eng.groups) == 2  # one group per (fingerprint, regs)
    assert len(eng.stats()["plans"]) == 2  # regs distinguish the keys
    assert all(ctx.device == "cpu" for ctx in eng.groups)
    # b=4 was allowed, but no launch may exceed a context's 2 members
    assert max(int(k) for k in eng.stats()["occupancy"]) <= 2
    assert np.array_equal(done[0].state, done[1].state)
    assert not np.array_equal(done[0].state, done[2].state)


@pytest.mark.parametrize("app", ["diffusion", "lbm"])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_batched_members_bitmatch_sequential(app, b):
    """Every member of a width-b engine launch retires with exactly the
    state an independent ``run_blocked`` produces, through cohort
    stacking, fused chunking and the single retirement transfer."""
    kern, mk, regs = (
        _diffusion_tenant() if app == "diffusion" else _lbm_tenant()
    )
    eng = _engine(_resolver(b_values=(b,)))
    for i in range(b):
        eng.submit(SimRequest(rid=i, core=kern, state=mk(i),
                              steps=STEPS, regs=regs))
    done = {c.rid: c for c in eng.run_until_drained()}
    assert len(done) == b
    (plan,) = eng.stats()["plans"].values()
    assert plan["b"] == b
    # all members admitted before the first launch: full-width cohort
    assert str(b) in eng.stats()["occupancy"]
    for i in range(b):
        ref = kern.run_blocked(
            torch.from_numpy(mk(i)), regs, steps=STEPS, m=plan["m"],
            block_h=plan["block_h"], double_buffer=plan["double_buffer"],
        )
        assert np.array_equal(done[i].state, ref.numpy()), (
            f"member {i}/{b} diverged from its sequential reference"
        )


def test_autotune_once_warm_engine_times_nothing(tmp_path):
    """First engine tunes under its budget; a second engine over the
    same study directory replays the journal and pins the identical
    plan with zero live timings (the injected timer makes 'zero'
    exact)."""
    kern, mk, regs = _diffusion_tenant()

    def engine(timer):
        return _engine(_resolver(tmp_path, budget=3, timer=timer))

    t1 = KeyTimer()
    eng1 = engine(t1)
    for i in range(2):
        eng1.submit(SimRequest(rid=i, core=kern, state=mk(i),
                               steps=STEPS, regs=regs))
    eng1.run_until_drained()
    s1 = eng1.stats()
    assert 0 < s1["live_timings"] <= 3
    assert len(t1.calls) == s1["live_timings"]
    assert s1["tuning_ticks"] > 0

    t2 = KeyTimer()
    eng2 = engine(t2)
    for i in range(2):
        eng2.submit(SimRequest(rid=10 + i, core=kern, state=mk(i),
                               steps=STEPS, regs=regs))
    eng2.run_until_drained()
    s2 = eng2.stats()
    assert s2["live_timings"] == 0 and not t2.calls
    assert s2["tuning_ticks"] == 0

    (p1,) = s1["plans"].values()
    (p2,) = s2["plans"].values()
    assert p2["replayed"] > 0 and p2["budget_spent"] == 0
    for name in ("block_h", "m", "d", "double_buffer", "b", "source"):
        assert p1[name] == p2[name], name


@pytest.mark.parametrize("bh_values", [(8, 16, 32), (64,)])
def test_budget_zero_falls_back_to_model_plan(bh_values):
    """Budget 0 pins the model's plan, legalized for the grid: a 64-row
    block on the 32-row grid runs as 32 rows (the reference pins the raw
    64 and raises at the first launch)."""
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(_resolver(budget=0, bh_values=bh_values))
    eng.submit(SimRequest(rid=0, core=kern, state=mk(0), steps=STEPS,
                          regs=regs))
    (done,) = eng.run_until_drained()
    (plan,) = eng.stats()["plans"].values()
    assert plan["source"] == "model" and plan["budget_spent"] == 0
    assert eng.stats()["live_timings"] == 0
    assert plan["block_h"] <= 32 and 32 % plan["block_h"] == 0
    ref = kern.run_blocked(torch.from_numpy(mk(0)), regs, steps=STEPS,
                           m=plan["m"], block_h=plan["block_h"])
    assert np.array_equal(done.state, ref.numpy())


def test_reset_counters_opens_fresh_window_keeping_plans():
    kern, mk, regs = _diffusion_tenant()
    eng = _engine()
    eng.submit(SimRequest(rid=0, core=kern, state=mk(0), steps=STEPS,
                          regs=regs))
    eng.run_until_drained()
    assert eng.stats()["launches"] > 0
    eng.reset_counters()
    s = eng.stats()
    assert s["launches"] == s["member_steps"] == s["completed"] == 0
    (plan,) = s["plans"].values()
    assert plan is not None  # pinned plans survive the window reset


def test_a_cpu_engine_never_waits_and_reset_zeroes_the_waits():
    """Host states at admission, cohorts of two with survivors restacked
    from the host: a CPU engine has nothing queued to wait on, so
    ``waits`` and ``wait_s`` stay 0; ``reset_counters`` zeroes both."""
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(_resolver(b_values=(2,), m_values=(2,)))
    for rid, steps in enumerate((2, 6, 4)):
        eng.submit(SimRequest(rid=rid, core=kern, state=mk(rid),
                              steps=steps, regs=regs))
    assert len(eng.run_until_drained()) == 3
    s = eng.stats()
    assert s["launches"] > 0 and s["occupancy"]["2"] > 0
    assert s["waits"] == 0 and s["wait_s"] == 0.0
    eng.waits, eng.wait_s = 3, 0.5  # as a card's engine would count
    assert (eng.stats()["waits"], eng.stats()["wait_s"]) == (3, 0.5)
    eng.reset_counters()
    s = eng.stats()
    assert s["waits"] == 0 and s["wait_s"] == 0.0


def _record_waits(eng, log):
    """Log ``("wait", launches so far)`` at each of the engine's waits,
    then make the wait (a no-op on the CPU)."""
    wait = eng._wait

    def recorded(device):
        log.append(("wait", eng.launches))
        wait(device)

    eng._wait = recorded


def test_engine_waits_only_where_the_host_copies_or_reads():
    """One 1,024-step request at m 8 from a host state: 128 launches and
    two waits, before the admission's copy and before the dissolution's
    ``.cpu()``; none after a launch."""
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(_resolver(b_values=(1,), m_values=(8,)))
    log = []
    _record_waits(eng, log)
    eng.submit(SimRequest(rid=0, core=kern, state=mk(0), steps=1024,
                          regs=regs))
    (done,) = eng.run_until_drained()
    assert eng.stats()["launches"] == 128
    assert log == [("wait", 0), ("wait", 128)]
    assert done.steps == 1024


def test_engine_drains_before_every_live_timing(tmp_path):
    """With a tuning budget, each live timing of a context still tuning
    follows a wait, while another context's cohort is in flight; the
    CPU's waits count nothing."""
    kd, mkd, rd = _diffusion_tenant()
    kl, mkl, rl = _lbm_tenant()
    log = []

    class Timer(KeyTimer):
        def __call__(self, plan, run, reps, warmup):
            log.append(("time", None))
            return super().__call__(plan, run, reps, warmup)

    timer = Timer()
    eng = _engine(_resolver(tmp_path, budget=3, timer=timer,
                            m_values=(1,)))
    _record_waits(eng, log)
    eng.submit(SimRequest(rid=0, core=kd, state=torch.from_numpy(mkd(0)),
                          steps=64, regs=rd))
    while next(iter(eng.groups.values()), None) is None or \
            next(iter(eng.groups.values())).cohort is None:
        eng.step()  # the diffusion context tunes, then launches
    eng.submit(SimRequest(rid=1, core=kl, state=torch.from_numpy(mkl(0)),
                          steps=8, regs=rl))
    assert len(eng.run_until_drained()) == 2
    assert len(timer.calls) == eng.stats()["live_timings"] > 3
    times = [i for i, (what, _) in enumerate(log) if what == "time"]
    assert all(i > 0 and log[i - 1][0] == "wait" for i in times)
    assert eng.stats()["waits"] == 0 and eng.stats()["wait_s"] == 0.0


def test_smem_pricing_and_model_agree_on_b():
    """The reference's VMEM rule scales with b, as there; the H100's
    shared-memory rule is priced per member (a block holds one member's
    tile); batched and sharded is declared infeasible."""
    from repro_torch.core.dse import GPUModel, StreamWorkload
    from repro_torch.core.legalize import stripe_vmem_bytes

    v1 = stripe_vmem_bytes(16, 2, 128, 3, halo=1, double_buffer=True)
    v4 = stripe_vmem_bytes(16, 2, 128, 3, halo=1, double_buffer=True, b=4)
    assert v4 == 4 * v1

    toy = StreamWorkload("toy", 8, 2, 2, 50, 40_000, 64 * 64, grid_w=64,
                         halo=1)
    model = GPUModel()
    p1 = model.evaluate(toy, 8, 2)
    p4 = model.evaluate(toy, 8, 2, b=4)
    assert p4.detail["b"] == 4
    assert p4.detail["vmem_bytes"] == 4 * p1.detail["vmem_bytes"]
    assert p4.detail["smem_bytes"] == p1.detail["smem_bytes"]
    pd = model.evaluate(toy, 8, 2, d=2, b=2)
    assert not pd.feasible
    assert any("batched" in lim for lim in pd.limits)


def test_engine_moves_states_to_the_kernels_device():
    """Numpy and CPU-tensor states are admitted onto the kernel's device;
    a state on another device type than a CPU engine's, or a kernel
    lowered for another device, is refused instead of running
    elsewhere."""
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(_resolver(b_values=(2,), m_values=(2,)))
    eng.submit(SimRequest(rid=0, core=kern, state=mk(0), steps=4,
                          regs=regs))
    eng.submit(SimRequest(rid=1, core=kern,
                          state=torch.from_numpy(mk(1)), steps=4,
                          regs=regs))
    eng.step()
    (group,) = eng.groups.values()
    assert group.cohort.stacked.shape == (2, 1, 32, 32)
    assert group.cohort.stacked.device == kern.device
    assert len(eng.run_until_drained()) == 2
    with pytest.raises(ValueError, match="given to an engine on cpu"):
        eng.submit(SimRequest(rid=2, core=kern,
                              state=torch.empty((1, 32, 32), device="meta"),
                              steps=4, regs=regs))
    kern.device = torch.device("meta")  # a kernel lowered elsewhere
    try:
        fresh = _engine()
        fresh.submit(SimRequest(rid=3, core=kern, state=mk(0), steps=4,
                                regs=regs))
        with pytest.raises(ValueError, match="StreamKernel on meta"):
            fresh.step()
    finally:
        kern.device = torch.device("cpu")


def test_survivors_restack_on_the_kernels_device():
    """A cohort dissolves when one member finishes; the survivor comes
    back as a host array and goes out again, alone, from the kernel's
    device (a width-1 cohort of a CPU engine runs the plain version, on
    the card the kernel)."""
    kern, mk, regs = _diffusion_tenant()
    eng = _engine(_resolver(b_values=(2,), m_values=(2,)))
    eng.submit(SimRequest(rid=0, core=kern, state=mk(0), steps=2,
                          regs=regs))
    eng.submit(SimRequest(rid=1, core=kern, state=mk(1), steps=6,
                          regs=regs))
    done = eng.step()
    assert [c.rid for c in done] == [0]
    (group,) = eng.groups.values()
    (survivor,) = group.members
    assert isinstance(survivor.state, np.ndarray)
    eng.step()
    assert isinstance(group.cohort.stacked, torch.Tensor)
    assert group.cohort.stacked.device == kern.device
    done = {c.rid: c for c in eng.run_until_drained()}
    assert eng.stats()["occupancy"] == {"1": 2, "2": 1}
    ref = kern.run_blocked(torch.from_numpy(mk(1)), regs, steps=6, m=2,
                           block_h=group.plan.block_h,
                           double_buffer=group.plan.double_buffer)
    assert np.array_equal(done[1].state, ref.numpy())


def test_engine_matches_the_jax_engine():
    """The port's engine and the JAX engine on the same requests (a
    diffusion tenant at 32×32, another at 64×64, uLBM at 32×32; two
    requests each): every completion within rtol 2e-5 / atol 1e-6, and
    every request retired in both."""
    from repro.serve.sim import PlanResolver as JResolver
    from repro.serve.sim import SimEngine as JEngine
    from repro.serve.sim import SimRequest as JRequest

    tenants = []
    for h, w, alpha in ((32, 32, 0.2), (64, 64, 0.1)):
        tk = tdif.DiffusionSimulation(h, w, alpha=alpha, device="cpu")
        jk = jdif.DiffusionSimulation(h, w, alpha=alpha)
        tenants.append((tk.kernel, jk.kernel, (alpha,),
                        _dif_members(2, h, w, seed=h)))
    tl = tlbm.LBMSimulation(tlbm.LBMProblem(32, 32), device="cpu")
    jl = jlbm.LBMSimulation(jlbm.LBMProblem(32, 32))
    tenants.append((tl.stream_kernel(), jl.stream_kernel(),
                    tl.stream_regs(), _lbm_members(2, seed=7)))
    kw = dict(budget=0, b_values=(1, 2), bh_values=(8, 16),
              m_values=(2, 4))
    teng = SimEngine(PlanResolver(**kw), device="cpu")
    jeng = JEngine(JResolver(**kw))
    rid = 0
    for tk, jk, regs, states in tenants:
        for s in states:
            assert teng.submit(SimRequest(rid=rid, core=tk, state=s,
                                          steps=STEPS, regs=regs))
            assert jeng.submit(JRequest(rid=rid, core=jk, state=s,
                                        steps=STEPS, regs=regs))
            rid += 1
    got = {c.rid: c.state for c in teng.run_until_drained()}
    want = {c.rid: c.state for c in jeng.run_until_drained()}
    assert sorted(got) == sorted(want) == list(range(rid))
    for r in got:
        np.testing.assert_allclose(got[r], np.asarray(want[r]), rtol=RTOL,
                                   atol=ATOL)


def test_module_exports_the_references_names():
    from repro_torch import serve

    for name in ("SimRequest", "SimCompletion", "TrialContext", "SimPlan",
                 "TuningSession", "PlanResolver", "_Active", "_Cohort",
                 "_Group", "SimEngine"):
        assert getattr(serve, name) is getattr(tsim_mod, name)
    assert [f for f in tsim_mod.TrialContext.__dataclass_fields__] == [
        "fingerprint", "h", "w", "regs", "device"]
