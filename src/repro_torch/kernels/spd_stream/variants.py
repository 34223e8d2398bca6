"""Time design choices of the generated SPD stream kernel side by side.

On the main path's launches (the uLBM PE at 4096², m 4, block_h 16;
diffusion at 8192², m 4, block_h 32; the uLBM program's collide+stream
cluster at 4096², m 1, block_h 16), the shipped plan
(:meth:`StripeProgram.tile`) beside the variants that undo one of its
choices:

- ``shared_state``: a register-state core printed with its state in
  shared memory (``cuda_source(reg_state=False)``: 256 threads, the slot
  stepped in place, a second ring slot, two blocks per SM);
- ``checked_taps``: every stencil tap through ``spd_tap``'s two bounds
  compares, the cell's (r, c) carried by additions (``cuda_source(
  taps="checked")``), in place of one load at a constant offset;
- ``ring1``: the shipped tile without the prefetch;
- ``t256c5`` / ``t512c2`` / ``t512c4``: other owner layouts of the
  register state (threads × cells a thread): 256 × 5 with registers
  sized for two blocks per SM on the two-block tile, 512 × 2 at one
  block on that tile, 512 × 4 at one block on the shipped tile;
- ``declarative``: the declarative launch (one block per tile, no
  prefetch) at its shipped plan; ``declarative_t256c5`` (register-state
  cores) the 256 × 5 layout at two blocks per SM;
  ``declarative_one_block`` (shared-state cores) the one-block rule's
  tile;
- ``scalar_copies``: every copy on the 4-byte path (``TILE_COPY_SCALAR``).

Variants that do not apply to a core (the register-state ones to
diffusion) or whose plan and source coincide with an earlier one are
left out. Every variant is held bitwise to the shipped launch's output,
and timed with CUDA events after a warm-up over three rounds, every
second in reverse order. ``chip_smoke.py`` phases 5 and 8 run
:func:`run`; alone, on the machine with the card::

    PYTHONPATH=src python -m repro_torch.kernels.spd_stream.variants
"""

from __future__ import annotations


def _defines(**kw) -> str:
    return "".join(f"#define {k} {v}\n" for k, v in kw.items())


def variant_plans(program, width: int, block_h: int, m: int):
    """``({name: (entry point, block_w, double_buffer, shared bytes)},
    {name: library source})``: each variant's launch, and the source of
    every variant that needs its own build (the others run the shipped
    library)."""
    from repro_torch.core.legalize import launch_tile, tile_smem_bytes

    def price(bw, planes):
        return tile_smem_bytes(block_h, bw, m, halo=program.halo,
                               halo_x=program.halo_x, planes=planes,
                               guard_rows=program.guard_rows)

    def shipped_planes(streamed):
        return lambda db: program.launch_planes(streamed=streamed,
                                                double_buffer=db)

    def plan(planes, *, streamed=True, blocks_per_sm=2, db=True):
        bw, db = launch_tile(width, block_h, m, halo=program.halo,
                             halo_x=program.halo_x, planes=planes,
                             double_buffer=db and streamed,
                             blocks_per_sm=blocks_per_sm,
                             guard_rows=program.guard_rows)
        return bw, db, price(bw, planes(db))

    S, D = "spd_multistep_streamed", "spd_multistep"
    bw0, db0 = program.tile(width, block_h, m)
    plans = {"kernel": (S, bw0, db0,
                        program.smem_bytes(block_h, bw0, m, streamed=True,
                                           double_buffer=db0))}
    src0 = program.cuda_source()
    srcs = {}
    if program.reg_state:
        # a register-state core is in place: one shared state buffer
        shared = lambda db: program.planes(1 + db)  # noqa: E731
        plans["shared_state"] = (S, *plan(shared))
        srcs["shared_state"] = program.cuda_source(reg_state=False)
    plans["checked_taps"] = plans["kernel"]
    srcs["checked_taps"] = program.cuda_source(taps="checked")
    plans["ring1"] = (S, bw0, False, plans["kernel"][3])
    if program.reg_state:
        two = plan(shipped_planes(True))
        for name, t, c, mb, p in (("t256c5", 256, 5, 2, two),
                                  ("t512c2", 512, 2, 1, two),
                                  ("t512c4", 512, 4, 1, plans["kernel"][1:])):
            plans[name] = (S, *p)
            srcs[name] = _defines(SPD_THREADS=t, SPD_CPT=c,
                                  SPD_MIN_BLOCKS=mb) + src0
    plans["declarative"] = (D, *plan(shipped_planes(False), streamed=False,
                                     blocks_per_sm=program.blocks_per_sm))
    if program.reg_state:
        plans["declarative_t256c5"] = (D, *plan(shipped_planes(False),
                                                streamed=False))
        srcs["declarative_t256c5"] = srcs["t256c5"]
    else:
        plans["declarative_one_block"] = (D, *plan(shipped_planes(False),
                                                   streamed=False,
                                                   blocks_per_sm=1))
    plans["scalar_copies"] = plans["kernel"]
    srcs["scalar_copies"] = "#define TILE_COPY_SCALAR 1\n" + src0
    seen, out = set(), {}
    for name, p in plans.items():
        key = (p, srcs.get(name))
        if key not in seen:
            seen.add(key)
            out[name] = p
    return out, {n: src for n, src in srcs.items() if n in out}


def run(program, state, regs, *, m: int, block_h: int, rounds: int = 3,
        iters: int = 20) -> dict:
    """``{name: {"ms": [...], "launch", "block_w", "double_buffer",
    "smem", "bitwise", "regs", "spill"}}`` for ``program`` on the card
    tensor ``state`` (``regs``/``spill``: ptxas's registers and spill
    bytes of the variant's streamed kernel)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.timing import ms_rounds

    _, h, w = state.shape
    plans, srcs = variant_plans(program, w, block_h, m)
    # one build per distinct source
    first = {}
    for n, src in srcs.items():
        first.setdefault(src, n)
    names = {n: f"spd_{program.name}_{first[src]}" for n, src in srcs.items()}
    build.build_all({names[n]: src for n, src in srcs.items()})
    lib0 = program.library()
    libs = {}
    for name, src in srcs.items():
        lib = libs[name] = build.load(names[name], src)
        for fn in ("spd_multistep_streamed", "spd_multistep"):
            getattr(lib, fn).argtypes = getattr(lib0, fn).argtypes
            getattr(lib, fn).restype = getattr(lib0, fn).restype
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rg = build.spd_regs(regs)
    outs, runs, res = {}, {}, {}
    for name, (entry, bw, db, smem) in plans.items():
        lib = libs.get(name, lib0)
        out = outs[name] = torch.empty_like(state)
        args = [1, h, w, block_h, bw, m] + (
            [int(db)] if entry.endswith("_streamed") else [])

        def launch(fn=getattr(lib, entry), args=args, smem=smem, out=out,
                   name=name):
            build.check(fn(state.data_ptr(), out.data_ptr(), *args, rg,
                           smem, state.device.index, stream),
                        f"spd variant {name}")

        launch()
        src = srcs.get(name, program.cuda_source())
        usage = build.ptxas_usage(build.library_path(
            names.get(name, f"spd_{program.name}"), src)
            .with_suffix(".log").read_text())
        r, spill = max(usage.values())
        res[name] = {"launch": entry, "block_w": bw, "double_buffer": db,
                     "smem": smem, "regs": r, "spill": spill}
        runs[name] = launch
    torch.cuda.synchronize()
    for name in plans:
        res[name]["bitwise"] = bool(torch.equal(outs[name], outs["kernel"]))
    for name, ms in ms_rounds(runs, rounds=rounds, iters=iters).items():
        res[name]["ms"] = ms
    return res


def report(label: str, res: dict) -> list[str]:
    return [f"  {label} {name} ({r['launch']}, block_w {r['block_w']}, "
            f"prefetch {r['double_buffer']}): "
            f"{sum(r['ms']) / len(r['ms']):.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in r['ms'])}); {r['smem']} B "
            f"shared, {r['regs']} registers, {r['spill']} spill bytes, "
            f"bitwise == shipped: {r['bitwise']}"
            for name, r in res.items()]


def main() -> None:
    import torch

    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm
    from repro_torch.kernels.timing import card_line

    if not torch.cuda.is_available():
        raise SystemExit("variants: needs the card")
    print(card_line())
    sim = lbm.LBMSimulation(lbm.LBMProblem(4096, 4096))
    f, attr, _ = lbm.taylor_green_init(4096, 4096)
    kern = sim.stream_kernel()
    for line in report("uLBM PE 4096^2 m 4", run(
            kern.program, sim.stream_state(f, attr), sim.stream_regs(), m=4,
            block_h=16)):
        print(line)
    prog = sim.program()
    f01 = prog.cluster_kernel(0, 1).program
    for line in report(f"{f01.name} 4096^2 m 1", run(
            f01, sim.stream_state(f, attr),
            sim.stream_regs()[prog.reg_slice(0, 1)], m=1, block_h=16)):
        print(line)
    big = dif.DiffusionSimulation(8192, 8192)
    for line in report("diffusion 8192^2 m 4", run(
            big.kernel.program, big.state(dif.sine_init(8192, 8192)[0]),
            (0.2,), m=4, block_h=32)):
        print(line)


if __name__ == "__main__":
    main()
