"""Console entry points of the port: ``python -m repro_torch.cli explore``
and ``python -m repro_torch.cli serve``.

The port of the JAX package's ``cli.py`` ``explore_main`` (docs/port.md
§dse) and ``serve_main`` (:func:`serve_main`, docs/port.md §serve).
``explore`` is the
design-space-exploration walkthrough, end to end: compile SPD cores, sweep
both target models in batched NumPy (including the device axis ``d``),
extract Pareto frontiers, and execute GPU lattice points through the
generated stream kernels via the pluggable search subsystem,
``Explorer.search`` (docs/pipeline.md §execute, §search): ``--strategy``
picks how the measurement budget is spent — ``exhaustive`` walks the
Pareto frontier top-down (the default), ``refine`` hill-climbs the
(block_h, m, d) neighborhood of the model's best points, ``halving``
races a wide model-ranked pool with cheap screening reps and full-rep
finals, ``tpe`` learns where to measure next with a seeded
Tree-structured Parzen Estimator (docs/pipeline.md §study) — and
``--budget N`` caps live measurements hard. ``--study NAME`` journals
every trial into a durable study (``--study-dir``, default
``$REPRO_TORCH_STUDY_DIR`` or ``build/repro_torch/studies``): re-running
with the same name replays completed trials, so an interrupted search
resumes with zero re-measurement; ``--seed`` fixes the TPE sampler's RNG
and ``--trials`` bounds its total observations. ``--devices N`` caps the
swept d axis (execution caps it at the card count); ``--mesh DYxDX`` pins
a 2-D device mesh and ``--mesh auto`` sweeps the column axis. ``--json
PATH`` dumps the machine-readable results (including ``strategy``,
``budget_spent``, ``declined`` and per-candidate measurement counts).

``--device`` is where the searched kernels run: ``cuda`` (the default:
the generated kernels on the card; without one the command exits with the
port's "no CUDA device" message) or ``cpu`` (their plain torch versions).
Runs are timed with the honest harness (``--reps`` median-of-reps, every
rep synchronized, host clock), the platform is calibrated so ``rel err``
diffs against the device actually running (``--no-calibrate`` compares
against the card's data-sheet peaks instead), and wall times persist in
the port's measurement cache (``$REPRO_TORCH_MEASURE_CACHE``, default
``build/repro_torch/measure-cache.json``; ``--no-cache`` to always
re-time). ``--program`` adds section 3c: the multi-core stream programs
(docs/port.md §program) — LBM as a 3-core collide+stream → boundary →
moments chain and the 2-core advection-diffusion app at 128×128 — with
the fusion partition swept as a lattice axis, executed through the
program back end (fused clusters as single launches, pipelined ones as a
captured step replayed on the card), under ``"program"`` in the report.
"""

from __future__ import annotations

import argparse
import json
import sys


def _point_dict(p) -> dict:
    return {
        "d": int(p.n),
        "dx": int(p.detail.get("dx", 1)),
        "dy": int(p.detail.get("dy", p.n)),
        "m": int(p.m),
        "block_h": int(p.detail.get("block_rows", 0)) or None,
        "feasible": bool(p.feasible),
        "sustained_gflops": float(p.sustained_gflops),
        "perf_per_watt": float(p.perf_per_watt),
        "limits": list(p.limits),
    }


def _search_line(res) -> str:
    return (f"(strategy={res.strategy}: {res.budget_spent} live "
            f"measurement(s), {len(res.executed)} point(s) executed, "
            f"{res.declined} plan(s) declined"
            + (f", {res.replayed} replayed from study {res.study!r}"
               if res.study else "") + ")")


def _programs(args, dev, strategy, mcache, exec_d, exec_dx, n_cards,
              study_kw) -> dict:
    """Section 3c: the fusion partition as a search axis, over both
    stream programs at 128×128; returns the ``"program"`` report."""
    from repro_torch.apps import lbm
    from repro_torch.apps.advection_diffusion import (
        AdvectionDiffusionSimulation,
        blob_init,
    )
    from repro_torch.core.explorer import render_executed
    from repro_torch.core.program import fusion_partitions

    print()
    print("=" * 72)
    print("3c) Stream programs: the fusion partition as a search axis")
    print("    (docs/port.md §program; `fuse` column = cluster sizes, "
          "e.g. 2+1)")
    print("=" * 72)
    psim = lbm.LBMSimulation(lbm.LBMProblem(128, 128, mode="wrap"),
                             device=dev)
    pf, pattr, _ = lbm.taylor_green_init(128, 128, device=dev)
    asim = AdvectionDiffusionSimulation(128, 128, device=dev)
    out = {}
    for label, prog, state, regs in (
        ("lbm_program", psim.program(), psim.stream_state(pf, pattr),
         psim.stream_regs()),
        ("advection_diffusion", asim.program,
         asim.state(blob_init(128, 128, device=dev)), asim.regs()),
    ):
        pex = prog.explorer(128 * 128, grid_w=128)
        psweep = pex.sweep_gpu(
            bh_values=(8, 16, 32), m_values=(1, 2, 4), d_values=exec_d,
            dx_values=exec_dx, double_buffer=args.double_buffer,
            fusion_values=fusion_partitions(prog.nstages),
        )
        pres = pex.search(
            psweep, state, regs, strategy=strategy, budget=args.budget,
            reps=args.reps, calibrate=args.calibrate, cache=mcache,
            max_devices=n_cards, **study_kw,
        )
        print(f"-- {label} ({prog.nstages} stages, partitions: "
              f"{', '.join(fusion_partitions(prog.nstages))})")
        print(render_executed(pres.executed))
        print(_search_line(pres))
        if pres.executed:
            best = pres.best
            print(f"-> best partition: {best.fusion} (block_h "
                  f"{best.block_h}, m {best.m}, {best.measured_mlups:.2f} "
                  "MLUPS)")
        out[label] = pres.as_dict()
    return out


def explore_main(argv: list[str] | None = None) -> dict:
    """``explore``: the DSE walkthrough, end to end. Returns the report
    that ``--json`` writes."""
    import torch

    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm
    from repro_torch.configs import get_arch
    from repro_torch.core.distribute import device_axis_values
    from repro_torch.core.explorer import render_executed
    from repro_torch.core.planner import ArchStats, plan, render_plans
    from repro_torch.core.search import STRATEGIES, ExhaustiveSearch
    from repro_torch.interop import resolve_device

    ap = argparse.ArgumentParser(prog="python -m repro_torch.cli explore",
                                 description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the searched kernels run: the card, or "
                         "their plain torch versions on the CPU")
    ap.add_argument("--arch", default="granite-34b")
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--topk", type=int, default=2,
                    help="frontier points to execute with --strategy "
                         "exhaustive; the other strategies choose their "
                         "own candidate counts (bound them with --budget)")
    ap.add_argument("--devices", type=int, default=4, metavar="N",
                    help="sweep the device axis d over powers of two up to "
                         "N (execution runs only the d the platform has)")
    ap.add_argument("--mesh", type=str, default=None, metavar="DYxDX",
                    help="2-D device mesh for the GPU sweeps (DESIGN.md "
                         "§15): 'DYxDX' pins the mesh shape (d = DY*DX), "
                         "'auto' sweeps every power-of-two column count up "
                         "to --devices")
    ap.add_argument("--json", type=str, default=None, metavar="PATH",
                    help="write the sweep/execution results as JSON")
    ap.add_argument("--no-execute", action="store_true",
                    help="skip the measured runs (sections 3 and 3b)")
    ap.add_argument("--strategy", default="exhaustive",
                    choices=sorted(STRATEGIES),
                    help="search strategy for the measured sweep "
                         "(docs/pipeline.md §search)")
    ap.add_argument("--budget", type=int, default=None, metavar="N",
                    help="hard cap on live measurements per app search "
                         "(cache hits are free; default: unbudgeted)")
    ap.add_argument("--reps", type=int, default=3, metavar="N",
                    help="measured timing reps per executed point (median "
                         "is reported; every rep is synchronized)")
    ap.add_argument("--calibrate", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="calibrate predictions against the device's "
                         "measured throughput/bandwidth so rel err is a "
                         "model-fidelity signal (--no-calibrate diffs "
                         "against the card's data-sheet peaks)")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the persistent measurement cache and "
                         "re-time every point")
    ap.add_argument("--double-buffer", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="stream with the prefetching launch "
                         "(docs/pipeline.md §stream); --no-double-buffer "
                         "requests the single-buffer launch")
    ap.add_argument("--study", type=str, default=None, metavar="NAME",
                    help="journal every trial into a durable named study "
                         "(docs/pipeline.md §study); re-running with the "
                         "same name resumes it with zero re-measurement")
    ap.add_argument("--study-dir", type=str, default=None, metavar="PATH",
                    help="directory holding study journals (default: "
                         "$REPRO_TORCH_STUDY_DIR or build/repro_torch/"
                         "studies)")
    ap.add_argument("--seed", type=int, default=0, metavar="N",
                    help="RNG seed for --strategy tpe")
    ap.add_argument("--trials", type=int, default=None, metavar="N",
                    help="cap on total tpe observations, replayed + "
                         "measured")
    ap.add_argument("--program", action="store_true",
                    help="also search the multi-core stream programs "
                         "(docs/port.md §program): LBM as a 3-core "
                         "collide+stream -> boundary -> moments chain and "
                         "the 2-core advection-diffusion app, with the "
                         "fusion partition (which stages share one "
                         "generated kernel) swept as a lattice axis — the "
                         "report table gains a `fuse` column and --json "
                         "carries the partition per executed point")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        ap.error(str(err))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    d_values = device_axis_values(args.devices)
    dx_values: tuple[int, ...] = (1,)
    if args.mesh:
        if args.mesh.strip().lower() == "auto":
            dx_values = d_values
        else:
            try:
                dy_s, dx_s = args.mesh.strip().lower().split("x")
                mesh_dy, mesh_dx = int(dy_s), int(dx_s)
            except ValueError:
                ap.error(f"--mesh {args.mesh!r}: expected DYxDX "
                         "(e.g. 2x4) or auto")
            if mesh_dy < 1 or mesh_dx < 1:
                ap.error("--mesh: DY and DX must be >= 1")
            d_values = (mesh_dy * mesh_dx,)
            dx_values = (mesh_dx,)
    report: dict = {"d_values": list(d_values),
                    "dx_values": list(dx_values), "mesh": args.mesh,
                    "device": str(dev)}

    print("=" * 72)
    print("1) The paper's case study: LBM on the Stratix V model")
    print("=" * 72)
    sim = lbm.LBMSimulation(lbm.LBMProblem(300, 720, mode="wrap"),
                            device=dev)
    ex = sim.explorer()
    sweep = ex.sweep_fpga(n_values=(1, 2, 4, 8), m_values=(1, 2, 4, 8))
    print(sweep.table(k=10))
    print()
    print("Pareto frontier (max throughput, max perf/W, min resources):")
    print(sweep.table(frontier_only=True))
    best = sweep.best("perf_per_watt")
    print(f"-> best configuration: (n, m) = ({best.n}, {best.m})  "
          f"[paper §III: (1, 4)]")
    report["fpga"] = {
        "best": {"n": int(best.n), "m": int(best.m),
                 "perf_per_watt": float(best.perf_per_watt)},
    }

    t = ex.gpu.target
    print()
    print("=" * 72)
    print("2) Hardware adaptation: temporal blocking on one NVIDIA H100 SXM")
    print(f"   ({t.hbm_gbs:.0f} GB/s HBM, {t.vpu_f32_tflops:.0f} TFLOP/s "
          f"FP32, {t.smem_bytes} B shared memory per block: data-sheet "
          f"peaks at {t.chip_peak_w:.0f} W),")
    print(f"   device axis d ∈ {d_values} (sharding + halo exchange)")
    print("=" * 72)
    tsweep = ex.sweep_gpu(d_values=d_values, dx_values=dx_values,
                          double_buffer=args.double_buffer)
    print(tsweep.table(k=8))
    print()
    print("GPU Pareto frontier:")
    print(tsweep.table(frontier_only=True, k=6))
    tbest = tsweep.best("sustained_gflops")
    report["gpu"] = {
        "best": _point_dict(tbest),
        "frontier": [_point_dict(p) for p in tsweep.frontier()],
    }

    if not args.no_execute:
        from repro_torch.core.measure import MeasurementCache

        mcache = None if args.no_cache else MeasurementCache()
        # Only propose device counts the platform can run.
        exec_d = device_axis_values(min(args.devices, n_cards))
        if args.mesh and args.mesh.strip().lower() != "auto":
            exec_d = tuple(d for d in d_values if d <= n_cards) or exec_d
        exec_dx = tuple(x for x in dx_values if x <= n_cards) or (1,)
        if args.strategy == "exhaustive":
            strategy = ExhaustiveSearch(k=args.topk, frontier_only=True)
        elif args.strategy == "tpe":
            from repro_torch.core.search import TPESearch

            strategy = TPESearch(seed=args.seed, max_trials=args.trials)
        else:
            strategy = args.strategy
        # One named study can hold both app searches: trials are keyed
        # by core fingerprint, so each search replays only its own.
        study_kw = dict(study=args.study, study_dir=args.study_dir)
        mode = ("the generated kernel on the card" if dev.type == "cuda"
                else "its plain torch version on the CPU")
        print()
        print("=" * 72)
        print(f"3) Model -> measurement: --strategy {args.strategy} "
              f"(budget: {args.budget if args.budget else 'none'}) over the")
        print(f"   generated uLBM stream kernel, 256x128, {mode}")
        print("=" * 72)
        msim = lbm.LBMSimulation(lbm.LBMProblem(256, 128, mode="wrap"),
                                 device=dev)
        mex = msim.explorer()
        msweep = mex.sweep_gpu(bh_values=(8, 16, 32, 64),
                               m_values=(1, 2, 4, 8), d_values=exec_d,
                               dx_values=exec_dx,
                               double_buffer=args.double_buffer)
        f0, attr, _ = lbm.taylor_green_init(256, 128, device=dev)
        mres = mex.search(
            msweep, msim.stream_state(f0, attr), msim.stream_regs(),
            strategy=strategy, budget=args.budget, reps=args.reps,
            calibrate=args.calibrate, cache=mcache, max_devices=n_cards,
            **study_kw,
        )
        print(render_executed(mres.executed))
        print(_search_line(mres))
        report["lbm"] = mres.as_dict()

        print()
        print("=" * 72)
        print("3b) Any SPD core on the frontier: 2-D diffusion through the")
        print(f"    generated stream kernel (256x128, {mode})")
        print("=" * 72)
        dsim = dif.DiffusionSimulation(256, 128, alpha=0.2, device=dev)
        dex = dsim.explorer()
        dsweep = dex.sweep_gpu(bh_values=(8, 16, 32, 64),
                               m_values=(1, 2, 4, 8), d_values=exec_d,
                               dx_values=exec_dx,
                               double_buffer=args.double_buffer)
        u0, _ = dif.sine_init(256, 128, device=dev)
        dres = dex.search(dsweep, dsim.state(u0), (dsim.alpha,),
                          strategy=strategy, budget=args.budget,
                          reps=args.reps, calibrate=args.calibrate,
                          cache=mcache, max_devices=n_cards, **study_kw)
        print(render_executed(dres.executed))
        print(_search_line(dres))
        halo = dsim.kernel.summary
        print(f"(inferred stencil: {len(halo.offsets)} offsets, "
              f"halo = {halo.halo_y} row/step — no hand-written kernel)")
        report["diffusion"] = dres.as_dict()

        if args.program:
            report["program"] = _programs(args, dev, strategy, mcache,
                                          exec_d, exec_dx, n_cards,
                                          study_kw)

        report["measure"] = {
            "reps": args.reps,
            "calibrate": bool(args.calibrate),
            "double_buffer": bool(args.double_buffer),
            "strategy": args.strategy,
            "budget": args.budget,
            "mesh": args.mesh,
            "cache": None if mcache is None else mcache.stats(),
            "study": args.study,
            "seed": args.seed,
            "trials": args.trials,
        }
        if mcache is not None:
            s = mcache.stats()
            print(f"(measurement cache: {s['hits']} hit(s), "
                  f"{s['misses']} miss(es) — {s['path']})")

    print()
    print("=" * 72)
    print(f"4) The same trade on an LM fleet: {args.arch} on "
          f"{args.chips} chips")
    print("   (spatial n -> dp, temporal m -> pp, in-PE -> tp)")
    print("=" * 72)
    cfg = get_arch(args.arch)
    stats = ArchStats(
        name=cfg.name, params=cfg.num_params(),
        active_params=cfg.active_params(), n_layers=cfg.n_layers,
        d_model=cfg.d_model, global_batch=args.batch, seq_len=args.seq,
    )
    print(render_plans(plan(stats, args.chips), top=10))

    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"\n[wrote {args.json}]")
    return report


def _grid(text: str) -> tuple[int, int]:
    h, _, w = text.lower().partition("x")
    return int(h), int(w)


def serve_mix(device, *, lbm_grid=(32, 32), lbm_init: str = "tgv",
              diffusion=((32, 32, 0.2), (64, 64, 0.1))) -> list:
    """The tenant mix of ``serve``: ``[(name, kernel, state, regs)]``, one
    diffusion tenant per ``(h, w, alpha)`` of ``diffusion``, then the uLBM
    PE at ``lbm_grid``, periodic Taylor-Green (``"tgv"``, the reference's
    32×32 tenant) or the lid-driven cavity (``"cavity"``, u_lid 0.05, the
    paper's 300×720 grid on the card), on ``device``."""
    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm

    mix = []
    for h, w, alpha in diffusion:
        sim = dif.DiffusionSimulation(h, w, alpha=alpha, device=device)
        u0, _ = dif.sine_init(h, w, device=device)
        mix.append((f"diffusion-{h}x{w}-a{alpha:g}", sim.kernel,
                    sim.state(u0), (sim.alpha,)))
    h, w = lbm_grid
    if lbm_init == "cavity":
        lsim = lbm.LBMSimulation(lbm.LBMProblem(h, w, u_lid=0.05),
                                 device=device)
        f0, attr = lbm.cavity_init(h, w, device=device)
    else:
        lsim = lbm.LBMSimulation(lbm.LBMProblem(h, w, mode="wrap"),
                                 device=device)
        f0, attr, _ = lbm.taylor_green_init(h, w, device=device)
    mix.append((f"lbm-{lbm_init}-{h}x{w}", lsim.stream_kernel(),
                lsim.stream_state(f0, attr), lsim.stream_regs()))
    return mix


def serve_traffic(engine, tenants, *, requests: int, steps: int,
                  rate: float, seed: int = 0):
    """Drive ``engine`` with ``requests`` jobs per tenant of ``steps``
    steps each, arriving open loop as a Poisson process of ``rate``
    expected arrivals per tick (the reference's schedule, from ``seed``),
    until every accepted job retires. Returns ``(completions, {rid:
    tenant index})``."""
    import numpy as np

    from repro_torch.serve.sim import SimRequest

    rng = np.random.default_rng(seed)
    total = requests * len(tenants)
    ticks = np.floor(np.cumsum(
        rng.exponential(1.0 / rate, size=total)
    )).astype(int)
    order = rng.permutation(np.repeat(np.arange(len(tenants)), requests))
    schedule = list(zip(ticks.tolist(), order.tolist()))
    completions, owner = [], {}
    rid = i = 0
    while i < len(schedule) or engine.queue or engine._active_count():
        while i < len(schedule) and schedule[i][0] <= engine.tick_count:
            _, core, state, regs = tenants[schedule[i][1]]
            if engine.submit(SimRequest(rid=rid, core=core, state=state,
                                        steps=steps, regs=regs)):
                owner[rid] = schedule[i][1]
            rid += 1
            i += 1
        completions.extend(engine.step())
    return completions, owner


def serve_report(engine, completions, cells: dict) -> dict:
    """Print the ``serve`` summary of a drained engine and return its
    stats with the latency percentiles, ``served_s`` (the host wall from
    the first arrival to the last retirement), ``mlups`` (the lattice
    updates of the completed requests, ``cells``: rid → H·W, over
    ``served_s``: the end-to-end served rate, tuning, admission, cohort
    dissolution and host gaps included) and ``launch_mlups`` (the same
    updates over the launches' host calls alone, a per-layer figure:
    nothing waits after a launch). One line splits the tick: the kernel's
    enqueue a launch, the shares of ``served_s`` the dissolutions and the
    tick's other host work took (``tick_s`` less the launches and the
    dissolutions), and the host's waits on the card with their share."""
    stats = engine.stats()
    lat = sorted(c.latency_s for c in completions)

    def pct(p):
        return lat[min(len(lat) - 1, int(p / 100 * len(lat)))] if lat else 0.0

    updates = sum(c.steps * cells[c.rid] for c in completions)
    served = (max(c.finished_s for c in completions)
              - min(c.submitted_s for c in completions)
              if completions else 0.0)
    wall = stats["launch_wall_s"]
    stats["served_s"] = served
    stats["mlups"] = updates / served / 1e6 if served > 0 else 0.0
    stats["launch_mlups"] = updates / wall / 1e6 if wall > 0 else 0.0
    stats["latency"] = {"p50_s": pct(50), "p95_s": pct(95),
                        "p99_s": pct(99)}
    print(f"{stats['completed']}/{stats['submitted']} completed "
          f"({stats['rejected']} rejected with backpressure), "
          f"{stats['launches']} launch(es) in {stats['ticks']} tick(s)")
    print(f"steady-state {stats['steps_per_s']:.1f} member-steps/s; "
          f"latency p50 {pct(50) * 1e3:.1f} ms / p95 {pct(95) * 1e3:.1f} "
          f"ms / p99 {pct(99) * 1e3:.1f} ms")
    print(f"served {updates} lattice updates in {served:.3f} s from first "
          f"arrival to drained: {stats['mlups']:.1f} MLUPS end to end "
          f"({stats['launch_mlups']:.1f} over the launches' host calls "
          "alone)")

    def share(seconds):
        return 100 * seconds / served if served > 0 else 0.0

    enqueue_us = 1e6 * stats["enqueue_s"] / max(stats["launches"], 1)
    host = stats["tick_s"] - wall - stats["dissolve_s"]
    print(f"tick split: enqueue {enqueue_us:.1f} us a launch; dissolution "
          f"{share(stats['dissolve_s']):.1f}% and the tick's other host "
          f"work {share(host):.1f}% of the served wall; waits on the card: "
          f"{stats['waits']} ({share(stats['wait_s']):.1f}%)")
    print("batch occupancy: " + ", ".join(
        f"b={k}: {v}" for k, v in stats["occupancy"].items()))
    print(f"tuning: {stats['live_timings']} live timing(s), "
          f"{stats['tuning_ticks']} tuning tick(s)"
          + (" — warm start" if stats["live_timings"] == 0 else ""))
    for key, plan in sorted(stats["plans"].items()):
        print(f"  {key}: block_h={plan['block_h']} m={plan['m']} "
              f"b={plan['b']} db={plan['double_buffer']} "
              f"[{plan['source']}, {plan['budget_spent']} timed, "
              f"{plan['replayed']} replayed]")
    return stats


def serve_main(argv: list[str] | None = None) -> dict:
    """``serve``: the multi-tenant simulation-serving engine (docs/port.md
    §serve) under open-loop Poisson load. Returns the stats that
    ``--json`` writes.

    Builds a tenant mix (2-D diffusion at two grids or two alphas, plus
    the uLBM PE), submits ``--requests`` jobs per tenant at
    ``--arrival-rate`` expected arrivals per engine tick, and serves them
    through :class:`repro_torch.serve.sim.SimEngine`: requests sharing a
    trial context stack along the batch axis ``b``, each context
    autotunes on first request under a hard ``--budget`` of live
    measurements, and ``--study-dir`` makes the tuning durable — a second
    invocation with the same directory warm-starts every plan with zero
    live timings. ``--device cpu`` serves the reference's mix (diffusion
    32×32 α 0.2 and 64×64 α 0.1, uLBM 32×32 Taylor-Green; 16 steps;
    ``b`` ∈ {1, 2, 4}) through the plain versions; on the card (the
    default) the mix is real-size: diffusion 2048² at α 0.2 and 0.1 (one
    fingerprint and grid, two contexts) and the uLBM PE on the paper's
    300×720 cavity, 64 steps, ``b`` ∈ {1, 2, 4, 8}. ``--diffusion-grid``
    and ``--lbm-grid`` change the grids.
    """
    from repro_torch.interop import resolve_device
    from repro_torch.serve.sim import PlanResolver, SimEngine

    ap = argparse.ArgumentParser(prog="python -m repro_torch.cli serve",
                                 description=serve_main.__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the served kernels run: the card, or their "
                         "plain torch versions on the CPU")
    ap.add_argument("--tenants", type=int, default=3, metavar="N",
                    help="tenant contexts in the mix, drawn cyclically "
                         "from the built-in set (two diffusion tenants, "
                         "then uLBM); each is a distinct trial context "
                         "with its own autotuned plan")
    ap.add_argument("--requests", type=int, default=8, metavar="N",
                    help="requests submitted per tenant")
    ap.add_argument("--steps", type=int, default=None, metavar="N",
                    help="simulation steps per request (default 16 on the "
                         "CPU, 64 on the card)")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    metavar="R",
                    help="open-loop Poisson intensity: expected "
                         "arrivals per engine tick (saturating rates "
                         "build the backlog that fills the batch axis)")
    ap.add_argument("--budget", type=int, default=4, metavar="N",
                    help="hard cap on live tuning measurements per "
                         "trial context (autotune-on-first-request; "
                         "exhaustion falls back to the model's plan)")
    ap.add_argument("--study-dir", type=str, default=None, metavar="PATH",
                    help="directory for the per-context tuning studies "
                         "(default: $REPRO_TORCH_STUDY_DIR or "
                         "build/repro_torch/studies); reuse it to "
                         "warm-start with zero live timings")
    ap.add_argument("--max-queue", type=int, default=64, metavar="N",
                    help="admission queue bound — submissions beyond it "
                         "are rejected with backpressure, never dropped "
                         "silently")
    ap.add_argument("--diffusion-grid", type=str, default=None,
                    metavar="HxW,HxW",
                    help="the two diffusion tenants' grids (default "
                         "32x32,64x64 on the CPU, 2048x2048,2048x2048 on "
                         "the card); alphas 0.2 and 0.1")
    ap.add_argument("--lbm-grid", type=str, default=None, metavar="HxW",
                    help="the uLBM tenant's grid (default 32x32 on the "
                         "CPU, 300x720 on the card)")
    ap.add_argument("--seed", type=int, default=0, metavar="N",
                    help="RNG seed for the arrival schedule")
    ap.add_argument("--json", type=str, default=None, metavar="PATH",
                    help="write the engine stats as JSON")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as err:
        ap.error(str(err))
    card = dev.type == "cuda"
    steps = args.steps or (64 if card else 16)
    grids = [_grid(g) for g in (
        args.diffusion_grid
        or ("2048x2048,2048x2048" if card else "32x32,64x64")).split(",")]
    mix = serve_mix(
        dev, lbm_grid=_grid(args.lbm_grid or ("300x720" if card
                                               else "32x32")),
        lbm_init="cavity" if card else "tgv",
        diffusion=[(h, w, a) for (h, w), a in zip(grids, (0.2, 0.1))],
    )
    tenants = [mix[i % len(mix)] for i in range(args.tenants)]
    engine = SimEngine(
        PlanResolver(budget=args.budget, study_dir=args.study_dir,
                     b_values=(1, 2, 4, 8) if card else (1, 2, 4)),
        max_queue=args.max_queue, device=dev,
    )
    total = args.requests * len(tenants)
    print("=" * 72)
    print(f"simulation-as-a-service on {dev}: {total} request(s) over "
          f"{len(tenants)} tenant(s),")
    print(f"rate {args.arrival_rate}/tick, {steps} steps/request, "
          f"tuning budget {args.budget}")
    print("   " + ", ".join(name for name, *_ in tenants))
    print("=" * 72)
    completions, owner = serve_traffic(
        engine, tenants, requests=args.requests, steps=steps,
        rate=args.arrival_rate, seed=args.seed,
    )
    cells = {rid: tenants[t][2].shape[-2] * tenants[t][2].shape[-1]
             for rid, t in owner.items()}
    stats = serve_report(engine, completions, cells)
    stats["device"] = str(dev)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(stats, fh, indent=2, sort_keys=True)
        print(f"\n[wrote {args.json}]")
    return stats


#: The subcommands of ``python -m repro_torch.cli``.
COMMANDS = {"explore": explore_main, "serve": serve_main}


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m repro_torch.cli {{{','.join(COMMANDS)}}} "
              "[options]", file=sys.stderr)
        sys.exit(2)
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
