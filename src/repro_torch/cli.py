"""Console entry points of the port: ``python -m repro_torch.cli explore``.

The port of the JAX package's ``cli.py`` ``explore_main`` (docs/port.md
§dse); its ``serve_main`` waits for the simulation service. The
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
re-time). The reference's ``--program`` waits for the port of stream
programs.
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


#: The subcommands of ``python -m repro_torch.cli``.
COMMANDS = {"explore": explore_main}


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m repro_torch.cli {{{','.join(COMMANDS)}}} "
              "[options]", file=sys.stderr)
        sys.exit(2)
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
