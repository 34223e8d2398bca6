"""The benchmark's runner: one cell of ``BENCHMARK.json``, one seed.

A cell names a configuration and a traffic mix; the harness finds their
files by name (``bench/README.md``):

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file,
  whose ``"app"`` names the adapter ``bench/apps/<app>.py`` that builds the
  port's system under test and hands the same inputs to the plain
  reference, and whose ``frozen`` holds the counts of the yardstick;
- ``bench/traffic/<traffic>.json`` is the mix, of one of the three kinds
  below, read by the general generators of :mod:`bench.loads`;
- ``bench/limits/<cell>.json`` holds the limit of each number compared;
- ``bench/metrics/<metric>.py`` reads each per-layer metric.

Kinds of mix:

``run``
    Chained simulations of ``steps_per_simulation`` steps through
    ``StreamKernel.run_for_point`` at the plan the DSE's model gives
    (``Explorer.sweep_gpu`` over the configuration's ``plan_lattice``, the
    first point by ``sustained_gflops``), each simulation starting from the
    last one's result, until ``--seconds`` have passed; every simulation
    ends in ``torch.cuda.synchronize`` of every card the run uses.
    ``mlups``: all lattice updates of the window over its seconds. Where
    the lattice has ``d`` > 1 (and ``dx``), the point's ``(d, dx)`` mesh
    runs ``ShardedStreamKernel.run_for_point``, one shard a card
    (:func:`mesh_kernel`): the state is cut into shards and gathered back
    to the first card for every simulation.
``serve``
    Open-loop arrivals on the wall clock (:func:`bench.loads.open_loop`)
    into one ``SimEngine`` whose contexts serve at the model's plan
    (``PlanResolver(budget=0)``), offered above the engine's capacity.
    ``served_mlups``: the lattice updates of the requests retired inside
    the window over its seconds. Requests due in the window are timed from
    their due time to retirement; after the window the engine drains for
    at most a minute; a request refused or never retired counts in
    ``failed``. The nearest-rank p50 and p95 of those latencies are
    per-layer metrics: above capacity the queue grows all through the
    window, so they swing with the smallest change.
``train``
    A language model's training step through the port's normal path
    (``registry.build`` → ``make_train_step``, adapter
    :mod:`bench.apps.lm_train`), with autograd on. Set-up runs the mix's
    ``checked_steps`` first steps, which warm up every shape; the window
    then runs steps back to back on fresh batches of
    :func:`bench.loads.token_batch`, a closed loop, with no wait of the
    harness's between steps, until ``--seconds`` have passed, and waits
    for the card once at its end. ``tokens_per_s``: the tokens of the
    window's steps over its seconds, the final wait included.

``correct`` of a ``run`` or ``serve`` cell: the plain reference
(:mod:`bench.reference`) runs, after the window and once the peak memory
is read, from the same inputs over the same steps as what the timed path
produced: one simulation of the chain (its index drawn from the seed) in
a run cell; in a serve cell a sample of the retired requests drawn from
the seed, the longest among them, each compared with the state the
engine handed back. The number compared is
the widest absolute gap of any word of the state. Of a ``train`` cell:
the configuration's reference (``train``) runs the checked steps from the
same weights on the same batches, after the window with the port's model
and optimizer state freed, and :func:`train_gaps` compares each step's
loss, each leaf's gradient norm at the first step and each leaf's change
after the last.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"

#: Where the harness keeps the program's build and kernel caches: fixed
#: directories inside the checkout, so a second run finds every kernel.
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "triton"}


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files read."""

    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict | None
    end_to_end: list
    per_layer: list


def find_cell(name: str) -> Cell:
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(ROOT / configs[entry["config"]]["file"])
    mix = read_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    lim_path = BENCH / "limits" / f"{name}.json"
    limits = read_json(lim_path) if lim_path.exists() else None
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return Cell(name, entry, config, mix, limits, e2e, per_layer)


def load_reader(metric: str):
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Reading:
    """What a run measured, for the per-layer readers."""

    kind: str
    frozen: dict
    peaks: dict | None  # one card's
    cells: int  # lattice cells of a run or serve mix, 0 for train
    window_s: float
    devices: int = 1  # distinct cards the run used
    updates: int = 0
    launches: int = 0
    steps: int = 0  # training steps of the window
    tokens: int = 0  # their tokens
    plan: dict = field(default_factory=dict)
    engine: dict = field(default_factory=dict)
    latency: dict = field(default_factory=dict)
    trace: dict | None = None


class Spans:
    """The harness's host spans: ``record_function`` while tracing, else
    nothing."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


def _sync(devices) -> None:
    """Wait for every CUDA card of ``devices``."""
    import torch

    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def distinct_devices(devices) -> list:
    """The distinct devices of ``devices``, in order; a CUDA device with no
    index is the current card."""
    import torch

    out = []
    for dev in map(torch.device, devices):
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in out:
            out.append(dev)
    return out


def max_abs_gap(out, ref) -> float:
    """The widest absolute gap between two states (inf where the program's
    state is not finite)."""
    import torch

    out = torch.as_tensor(out, device=ref.device)
    if not bool(torch.isfinite(out).all()):
        return math.inf
    return float((out.float() - ref.float()).abs().max())


def _model_plan(system, config: dict):
    lat = config["plan_lattice"]
    sweep = system.explorer().sweep_gpu(
        bh_values=lat["block_h"], m_values=lat["m"], d_values=lat["d"],
        dx_values=lat.get("dx", [1]))
    return sweep.best(key="sustained_gflops")


def mesh_devices(device, d: int) -> list:
    """One device a shard: the cards ``cuda:0 … cuda:d-1``, each once, or
    the CPU d times."""
    import torch

    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(d)]
    return [device] * d


def mesh_kernel(kernel, d: int, dx: int, device):
    """The kernel that runs a ``(d / dx, dx)`` mesh, and the devices it
    uses: ``kernel`` itself where ``d`` is 1, else ``kernel.sharded`` on
    :func:`mesh_devices`."""
    if d == 1:
        return kernel, [kernel.device]
    devices = mesh_devices(device, d)
    return kernel.sharded(d, devices, dx=dx), devices


# --------------------------------------------------------------------------
# run: chained simulations at the model's plan
# --------------------------------------------------------------------------


def _run_kind(cell, app, seed, spans, device, log):
    import numpy as np
    import torch

    mix, config = cell.mix, cell.config
    h, w = mix["grid"]
    steps = int(mix["steps_per_simulation"])
    tenant = mix.get("tenant", {})
    system = app.build(config, (h, w), device)
    regs = system.regs(tenant)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = system.states(mix["init"], 1, gen)[0]
    with spans("explore"):
        point = _model_plan(system, config)
    d, dx = int(point.detail.get("d", 1)), int(point.detail.get("dx", 1))
    kern, devices = mesh_kernel(system.kernel, d, dx, device)
    devices = distinct_devices([state.device] + devices)
    # One fused launch at the point, legalized by the kernel itself.
    warm, plan = kern.run_for_point(state, regs, point=point)
    _sync(devices)
    del warm
    block_h, m, db = plan
    if steps % m:
        raise ValueError(f"plan {point} fuses {m} steps, which do not "
                         f"divide {steps}")
    tile = ""
    if d == 1:
        block_w, db = kern.tile(w, block_h, m, double_buffer=db)
        tile = f", block_w {block_w}"
    log(f"plan: model's pick mesh ({d // dx}, {dx}) block_h "
        f"{point.detail['block_rows']} m {point.m} "
        f"({point.sustained_gflops:.1f} GF/s predicted); run at block_h "
        f"{block_h}{tile}, m {m}, prefetch {db}, on "
        f"{', '.join(map(str, devices))}")
    pick = int(np.random.default_rng(seed).integers(
        int(mix["sample_first"])))
    program = system.kernel.program
    return {
        "system": system, "kern": kern, "regs": regs, "tenant": tenant,
        "state": state, "point": point, "steps": steps, "pick": pick,
        "devices": devices,
        "plan": {"block_h": block_h, "m": m, "d": d, "dy": d // dx,
                 "dx": dx, **({"block_w": block_w} if d == 1 else {})},
        "launch_count": lambda: program.launches.get(program.name, 0),
    }


def _run_window(s, seconds, spans):
    kern, regs, point, steps = s["kern"], s["regs"], s["point"], s["steps"]
    l0 = s["launch_count"]()
    prev, n, kept = s.pop("state"), 0, None
    t0 = time.perf_counter()
    with spans("bench.window"):
        while True:
            with spans("run_for_point"):
                out, _ = kern.run_for_point(prev, regs, point=point,
                                            steps=steps)
                _sync(s["devices"])
            if n == s["pick"]:
                kept = (prev, out)
            last = (prev, out)
            n += 1
            prev = out
            if time.perf_counter() - t0 >= seconds:
                break
    window = time.perf_counter() - t0
    s["kept"] = kept or last
    s["checked"] = n - 1 if kept is None else s["pick"]
    s["sims"] = n
    del prev, out, last, kept
    return window, s["launch_count"]() - l0


#: The lower-precision controls: the reference put in the program's place,
#: computed in bfloat16 throughout (``bf16``), or with its float32
#: arithmetic and the state rounded to bfloat16 after every step
#: (``bf16_state``, the step that would halve a launch's bytes).
CONTROLS = ("bf16", "bf16_state")

#: Readings beside the controls: the program's fault of handing back the
#: state it was given, unchanged (``unchanged``).
FAULTS = ("unchanged",)


def advance(system, state, tenant: dict, steps: int, mode: str = "f32"):
    """``state`` advanced ``steps`` steps by the plain reference in
    ``mode``: ``"f32"`` or one of :data:`CONTROLS`."""
    import torch

    if mode == "f32":
        return system.reference(state, tenant, steps)
    if mode == "unchanged":
        return state
    if mode == "bf16":
        return system.reference(state, tenant, steps, dtype=torch.bfloat16)
    if mode != "bf16_state":
        raise ValueError(f"unknown control {mode!r}")
    state = state.bfloat16().float()
    for _ in range(int(steps)):
        state = system.reference(state, tenant, 1).bfloat16().float()
    return state


def _run_check(s, control):
    inp, out = s.pop("kept")
    ref = advance(s["system"], inp, s["tenant"], s["steps"])
    gaps = {"max_abs_gap": max_abs_gap(out, ref)}
    if control:
        for mode in CONTROLS + FAULTS:
            low = advance(s["system"], inp, s["tenant"], s["steps"], mode)
            gaps[f"control_{mode}_max_abs_gap"] = max_abs_gap(low, ref)
    return gaps


# --------------------------------------------------------------------------
# serve: open-loop tenants into SimEngine at the model's plan
# --------------------------------------------------------------------------


def _serve_kind(cell, app, seed, seconds, spans, device, log, study_dir):
    import numpy as np
    import torch

    from bench.loads import open_loop
    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    mix, config = cell.mix, cell.config
    h, w = mix["grid"]
    system = app.build(config, (h, w), device)
    kern = system.kernel
    tenants = mix["tenants"]
    regs = [system.regs(t) for t in tenants]
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = [system.states(mix["init"], int(mix["pool"]), gen)
             for _ in tenants]
    lat = config["plan_lattice"]
    engine = SimEngine(
        PlanResolver(budget=0, bh_values=lat["block_h"], m_values=lat["m"],
                     d_values=lat["d"], b_values=config["serve_b"],
                     study_dir=study_dir),
        max_queue=int(mix["max_queue"]),
        max_active=int(mix["max_active"]), device=device)
    # Warm-up: every context opens its plan, and every batch width and
    # fused-step count the traffic can give is launched and dissolved.
    bmax = max(config["serve_b"])
    smin, mult = int(mix["steps"]["min"]), int(mix["steps"]["multiple"])
    rid = -1
    with spans("explore"):
        for t, pool in enumerate(pools):
            for k in range(bmax):
                engine.submit(SimRequest(
                    rid=rid, core=kern, state=pool[k % len(pool)],
                    steps=smin + mult * (k % 2), regs=regs[t]))
                rid -= 1
        engine.run_until_drained()
    stats = engine.stats()
    for key, plan in sorted(stats["plans"].items()):
        log(f"plan {key}: block_h {plan['block_h']} m {plan['m']} b "
            f"{plan['b']} prefetch {plan['double_buffer']} "
            f"[{plan['source']}]")
    engine.reset_counters()
    sched = open_loop(mix, seed, seconds)
    sample = set(np.random.default_rng(seed).choice(
        sched["in_window"], size=min(int(mix["sample"]), sched["in_window"]),
        replace=False).tolist())
    return {
        "system": system, "kern": kern, "engine": engine, "regs": regs,
        "pools": pools, "sched": sched, "sample": sample,
        "request": SimRequest, "devices": distinct_devices([device]),
    }


def _serve_window(s, seconds, spans, profiler_stop):
    engine, kern, sched = s["engine"], s["kern"], s["sched"]
    offs, tenant, steps, pool_ix = (sched["due_s"], sched["tenant"],
                                    sched["steps"], sched["pool"])
    SimRequest = s["request"]
    n_total = len(offs)
    done, rejected = {}, set()
    kept, longest = {}, None
    late = 0.0

    def take(comps):
        nonlocal longest
        for c in comps:
            done[c.rid] = c.finished_s
            if c.rid in s["sample"]:
                kept[c.rid] = c.state
            if longest is None or c.steps > longest[1]:
                longest = (c.rid, c.steps, c.state)

    def submit(i, now):
        nonlocal late
        t = int(tenant[i])
        with spans("submit"):
            ok = engine.submit(SimRequest(
                rid=i, core=kern, state=s["pools"][t][int(pool_ix[i])],
                steps=int(steps[i]), regs=s["regs"][t]))
        if not ok:
            rejected.add(i)
        late = max(late, now - due[i])

    def busy():
        return bool(engine.queue) or engine._active_count() > 0
    i = 0
    tick0 = engine.tick_count
    with spans("bench.window"):
        base = time.monotonic()
        end = base + seconds
        due = [base + o for o in offs]
        while True:
            now = time.monotonic()
            if now >= end:
                break
            while i < n_total and due[i] <= now:
                submit(i, now)
                i += 1
            if busy():
                with spans("engine.step"):
                    take(engine.step())
            else:
                nxt = min(due[i] if i < n_total else end, end)
                with spans("wait_arrival"):
                    time.sleep(max(0.0, nxt - time.monotonic()))
        now = time.monotonic()
        while i < n_total and due[i] < end:
            submit(i, now)
            i += 1
        _sync(s["devices"])
    window = time.monotonic() - base
    in_window = i
    stats = engine.stats()
    backlog = len(engine.queue) + engine._active_count()
    profiler_stop()
    drain_end = time.monotonic() + 60.0
    while busy() and time.monotonic() < drain_end:
        take(engine.step())
    lat = sorted((done[r] - due[r]) * 1e3 for r in range(in_window)
                 if r in done)
    h, w = s["system"].grid
    served = sum(int(steps[r]) for r in range(in_window)
                 if r in done and done[r] <= end) * h * w
    failed = sum(1 for r in range(in_window) if r not in done)
    s.update(kept=kept, longest=longest, in_window=in_window)
    return {
        "window_s": window, "stats": stats, "latencies_ms": lat,
        "served_updates": served,
        "attempted": in_window, "failed": failed,
        "rejected": len(rejected), "late_s": late,
        "backlog_at_close": backlog,
        "ticks": engine.tick_count - tick0,
        "launch_wall_s": stats["launch_wall_s"],
        "launches": stats["launches"],
    }


def nearest_rank(sorted_vals, p: float) -> float:
    """The nearest-rank p-th percentile of sorted values."""
    k = max(1, math.ceil(p / 100.0 * len(sorted_vals)))
    return sorted_vals[k - 1]


def _serve_check(s, control):
    import torch

    system, sched = s["system"], s["sched"]
    kept = dict(s["kept"])
    if s["longest"] is not None:
        rid, _, state = s["longest"]
        kept.setdefault(rid, state)
    kept = {r: st for r, st in kept.items() if r < s["in_window"]}
    modes = ("f32",) + (CONTROLS + FAULTS if control else ())
    gaps = {"max_abs_gap": 0.0}
    gaps.update({f"control_{m}_max_abs_gap": 0.0 for m in modes[1:]})
    by_tenant: dict[int, list] = {}
    for r in sorted(kept):
        by_tenant.setdefault(int(sched["tenant"][r]), []).append(r)
    tenants = s["mix_tenants"]
    for t, rids in by_tenant.items():
        # One batched reference a tenant, advanced from one member's step
        # count to the next; each member is compared when it reaches its.
        rids.sort(key=lambda r: int(sched["steps"][r]))
        pool = s["pools"][t]
        start = torch.stack([pool[int(sched["pool"][r])] for r in rids])
        cur = {m: start for m in modes}
        at = 0
        while rids:
            target = int(sched["steps"][rids[0]])
            if target > at:
                cur = {m: advance(system, st, tenants[t], target - at, m)
                       for m, st in cur.items()}
                at = target
            left = []
            for row, r in enumerate(rids):
                if int(sched["steps"][r]) != at:
                    left.append(row)
                    continue
                ref = cur["f32"][row]
                gaps["max_abs_gap"] = max(gaps["max_abs_gap"],
                                          max_abs_gap(kept[r], ref))
                for m in modes[1:]:
                    key = f"control_{m}_max_abs_gap"
                    gaps[key] = max(gaps[key], max_abs_gap(cur[m][row], ref))
            rids = [rids[row] for row in left]
            cur = {m: st[left] for m, st in cur.items()}
    gaps["checked"] = len(kept)
    return gaps


# --------------------------------------------------------------------------
# train: a language model's training steps, back to back
# --------------------------------------------------------------------------

#: The control of a train cell: the reference put in the program's place
#: with every matrix product's inputs rounded to float8.
TRAIN_CONTROLS = ("fp8",)


def _train_kind(cell, app, seed, spans, device, log):
    system = app.build(cell.config, cell.mix, device, seed)
    system.checked_steps(spans)
    params = sum(math.prod(spec[1]) for spec in system.specs)
    log(f"train: {system.cfg.name} at {system.cfg.n_layers} layers, "
        f"{params:,} parameters, {system.tokens_per_step:,} tokens a step, "
        f"{system.k} checked steps in set-up; set-up phases (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in system.phases.items()))
    return {"system": system, "devices": distinct_devices([device]),
            "phases": system.phases}


def _train_window(s, seconds, spans):
    system = s["system"]
    n = 0
    t0 = time.perf_counter()
    with spans("bench.window"):
        while True:
            with spans("train.step"):
                system.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(s["devices"])
    return time.perf_counter() - t0, n, n * system.tokens_per_step


def _gap(prog: float, ref: float, den: float) -> float:
    """``|prog − ref| / den``, infinite where the program's number is not
    finite."""
    if not math.isfinite(prog):
        return math.inf
    if den == 0:
        return 0.0 if prog == ref else math.inf
    return abs(prog - ref) / den


def leaf_gaps(prog: dict, ref: dict, key: str, names) -> dict:
    """``{leaf: |prog − ref| / max(ref, the median leaf's ref)}`` of the
    per-leaf norms ``key`` over the leaves ``names``."""
    med = statistics.median(ref[key][n] for n in names)
    return {n: _gap(prog[key][n], ref[key][n], max(ref[key][n], med))
            for n in names}


def train_gaps(prog: dict, ref: dict) -> dict:
    """The numbers a train cell compares, from two ``train`` readings:

    - ``loss_rel_gap``: the largest over the checked steps of
      ``|loss − loss_ref| / loss_ref``;
    - ``grad_norm_gap``: over the leaves, the largest gap of the first
      step's gradient norms, ``|‖g‖ − ‖g_ref‖|``, over the larger of the
      leaf's ``‖g_ref‖`` and the median leaf's;
    - ``update_norm_gap``: the same of the leaves' changes after the last
      checked step.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding, moved by round-off alone) are left out
    of both (:func:`counted_leaves`)."""
    names = counted_leaves(ref)
    return {
        "loss_rel_gap": max(_gap(p, r, abs(r)) for p, r in
                            zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": max(leaf_gaps(prog, ref, "grad_norm",
                                       names).values()),
        "update_norm_gap": max(leaf_gaps(prog, ref, "change_norm",
                                         names).values()),
    }


def counted_leaves(ref: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g = ref["grad_norm"]
    floor = 1e-3 * statistics.median(g.values())
    return [name for name, x in g.items() if x >= floor]


def _train_check(s, control):
    import gc

    import torch

    system = s.pop("system")
    prog = system.readings()
    ref_mod, config, seed, device = (system.ref, system.config, system.seed,
                                     system.device)
    batches = [system.batch(k) for k in range(int(system.mix[
        "checked_steps"]))]
    system.free()
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ref = ref_mod.train(config, seed, batches, device)
    ref_s = time.perf_counter() - t0
    gaps = train_gaps(prog, ref)
    if control:
        for mode in TRAIN_CONTROLS:
            low = ref_mod.train(config, seed, batches, device, mode)
            gaps.update({f"control_{mode}_{k}": v
                         for k, v in train_gaps(low, ref).items()})
    names = counted_leaves(ref)
    gaps["checked"] = {"steps": len(batches), "reference_s": ref_s,
                       "reference_peak_bytes": (
                           torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0),
                       "loss": prog["loss"],
                       "loss_ref": ref["loss"], "dropped_ref": ref["dropped"],
                       "leaf_gaps": {key: leaf_gaps(prog, ref, key, names)
                                     for key in ("grad_norm",
                                                 "change_norm")}}
    return gaps


# --------------------------------------------------------------------------
# one cell, one seed
# --------------------------------------------------------------------------


def _device_info(devices) -> dict:
    """The result line's ``device``, read from what the run did. On cards,
    ``count`` is the cards of the machine on which the run allocated
    memory (a peak above 0), ``memory_peak_bytes`` the fullest one's peak,
    each one's beside it, and ``kind`` the first one's (the run fails
    where they differ); ``devices``, those the run's system was given,
    only tells cards from the CPU, which counts once."""
    import torch

    devices = distinct_devices(devices)
    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices),
                "memory_peak_bytes": 0}
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    peaks = {card: int(torch.cuda.max_memory_allocated(card))
             for card in cards}
    used = [card for card in cards if peaks[card] > 0]
    if not used:
        raise RuntimeError("the run allocated no memory on any card")
    kinds = [torch.cuda.get_device_name(card) for card in used]
    if len(set(kinds)) > 1:
        raise RuntimeError(f"the run's cards differ in kind: {kinds}")
    per_card = [peaks[card] for card in used]
    return {"platform": "gpu", "kind": kinds[0], "count": len(used),
            "memory_peak_bytes": max(per_card),
            "memory_peak_bytes_per_device": per_card}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             control: bool = False, t0: float | None = None,
             log=None, config: dict | None = None) -> dict:
    """Run cell ``name`` once; returns the result line's fields (``info``
    holds what is printed on earlier lines). ``overrides`` replace keys of
    the traffic mix (small grids for the CPU tests, rates for the rate
    sweep), ``config`` the configuration (the fault tests' batch widths);
    ``control`` also reads the lower-precision controls' gaps."""
    t0 = time.time() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    for var, path in CACHE_DIRS.items():
        os.environ.setdefault(var, str(path))
    import torch

    # One process with one intra-op thread offers the load: the engine's
    # host path is Python, and idle pool threads only add jitter.
    torch.set_num_threads(1)
    cell = find_cell(name)
    cell.mix = {**cell.mix, **(overrides or {})}
    cell.config = config or cell.config
    kind = cell.mix["kind"]
    app = importlib.import_module(f"bench.apps.{cell.config['app']}")
    dev = torch.device(device)
    spans = Spans(trace)
    tmp = tempfile.mkdtemp(prefix="bench-")
    os.environ["REPRO_TORCH_STUDY_DIR"] = os.path.join(tmp, "studies")
    os.environ["REPRO_TORCH_MEASURE_CACHE"] = os.path.join(tmp,
                                                           "measure.json")
    prof = None

    def start_profiler():
        nonlocal prof
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()

    def stop_profiler():
        if prof is not None and not getattr(prof, "_bench_done", False):
            prof.__exit__(None, None, None)
            prof._bench_done = True

    # A training step records its graph; the run and serve kinds none.
    grad_mode = (contextlib.nullcontext() if kind == "train"
                 else torch.no_grad())
    try:
        with grad_mode:
            if kind == "run":
                s = _run_kind(cell, app, seed, spans, dev, log)
            elif kind == "serve":
                s = _serve_kind(cell, app, seed, seconds, spans, dev, log,
                                os.path.join(tmp, "studies"))
                s["mix_tenants"] = cell.mix["tenants"]
            elif kind == "train":
                s = _train_kind(cell, app, seed, spans, dev, log)
            else:
                raise ValueError(f"unknown traffic kind {kind!r}")
            devices = s["devices"]
            _sync(devices)
            setup_s = time.time() - t0
            start_profiler()
            if kind == "run":
                window, launches = _run_window(s, seconds, spans)
                _sync(devices)
                stop_profiler()
                h, w = cell.mix["grid"]
                updates = s["sims"] * s["steps"] * h * w
                e2e = {"mlups": updates / window / 1e6, "setup_s": setup_s}
                attempted, failed, latency = s["sims"], 0, {}
                engine_stats, out_info = {}, {
                    "simulations": s["sims"], "checked_simulation":
                    s["checked"], "plan": s["plan"]}
            elif kind == "train":
                window, steps, tokens = _train_window(s, seconds, spans)
                stop_profiler()
                e2e = {"tokens_per_s": tokens / window, "setup_s": setup_s}
                attempted, failed, latency, engine_stats = steps, 0, {}, {}
                launches, updates = 0, 0
                out_info = {"steps": steps, "tokens": tokens,
                            "setup_phases_s": s["phases"]}
            else:
                out = _serve_window(s, seconds, spans, stop_profiler)
                window, launches, updates = out["window_s"], 0, 0
                lat = out["latencies_ms"]
                if not lat:
                    raise RuntimeError("no request due in the window "
                                       "retired")
                e2e = {"served_mlups": out["served_updates"] / window / 1e6,
                       "setup_s": setup_s}
                latency = {"p50_ms": nearest_rank(lat, 50),
                           "p95_ms": nearest_rank(lat, 95)}
                attempted, failed = out["attempted"], out["failed"]
                engine_stats = out["stats"]
                out_info = {k: out[k] for k in (
                    "rejected", "late_s", "backlog_at_close", "ticks",
                    "launch_wall_s", "launches")}
                out_info["retired"] = len(lat)
                out_info["latency_p50_ms"] = latency["p50_ms"]
                out_info["latency_p95_ms"] = latency["p95_ms"]
                out_info["latency_p99_ms"] = nearest_rank(lat, 99)
                out_info["latency_max_ms"] = lat[-1]
            device_info = _device_info(devices)
            reduced = None
            if prof is not None:
                from bench.tracing import reduce_profile

                reduced = reduce_profile(prof, [
                    d.index for d in devices if d.type == "cuda"] or None,
                    cell.config["frozen"].get("trace_ops"))
                prof = None
            with spans("check"):
                if kind == "run":
                    gaps = _run_check(s, control)
                elif kind == "serve":
                    gaps = _serve_check(s, control)
                else:
                    gaps = _train_check(s, control)
            del s
    finally:
        stop_profiler()
        shutil.rmtree(tmp, ignore_errors=True)
    cells = math.prod(cell.mix["grid"]) if "grid" in cell.mix else 0
    peaks = None
    if dev.type == "cuda":
        from bench.roofline import peaks_for

        peaks = peaks_for(device_info["kind"])
    reading = Reading(kind=kind, frozen=cell.config["frozen"], peaks=peaks,
                      cells=cells, window_s=window,
                      devices=device_info["count"], updates=updates,
                      launches=launches,
                      steps=out_info.get("steps", 0),
                      tokens=out_info.get("tokens", 0),
                      plan=out_info.get("plan", {}), engine=engine_stats,
                      latency=latency, trace=reduced)
    return _result(cell, trace, e2e, reading, gaps, attempted, failed,
                   device_info, out_info)


def _result(cell, trace, e2e, reading, gaps, attempted, failed,
            device_info, info) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if reading.trace is not None and reading.peaks is not None:
            for key in ("busy_s", "busy_s_per_device", "window_s"):
                device_info[key] = reading.trace[key]
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    checks = {}
    limits = cell.limits or {}
    for key, value in gaps.items():
        if key == "checked" or key.startswith("control_"):
            continue
        lim = limits.get(key, {}).get("limit")
        checks[key] = {"value": min(value, 3.4e38), "limit": lim}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace and reading.trace is not None and reading.peaks is not None:
        from bench.tracing import breakdown

        result["breakdown"] = breakdown(reading.trace)
    result["checks"] = checks
    info = dict(info)
    info.update({k: v for k, v in gaps.items() if k not in checks})
    info["window_s"] = reading.window_s
    return {"result": result, "info": info}
