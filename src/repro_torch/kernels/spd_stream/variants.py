"""Time design choices of the generated SPD stream kernel side by side.

On the main path's streamed launches (the uLBM PE at 4096², m 4, block_h
16; diffusion at 8192², m 4, block_h 32), the shipped plan
(:meth:`StripeProgram.tile`: the widest tile with room for two blocks on
an SM, with the ring's second slot where that fits, the state stepped in
place where the core allows) beside the variants that undo one of its
choices:

- ``one_block``: the widest tile that fits one block per SM, two slots
  where they fit (the plan before two blocks per SM were priced);
- ``one_block_ring1``: that tile with one slot and the same shared
  memory reserved, so only the overlap differs from ``one_block``;
- ``two_blocks_ring2``: the widest tile with room for two blocks per SM
  and two slots, where that is not the shipped tile;
- ``ring1``: the shipped tile with one slot, at its own price;
- ``ping_pong``: a core that may step in place built to ping/pong two
  state buffers instead, on the tile the plan then takes;
- ``scalar_copies``: the shipped plan with every copy on the 4-byte path
  (the library rebuilt with ``TILE_COPY_SCALAR``).

Plans that coincide with an earlier one are left out. Every variant is
held bitwise to the shipped launch's output, and timed with CUDA events
after a warm-up over three rounds, every second in reverse order.
``chip_smoke.py`` phase 5 runs :func:`run`; alone, on the machine with the
card::

    PYTHONPATH=src python -m repro_torch.kernels.spd_stream.variants
"""

from __future__ import annotations

_IN_PLACE = "static constexpr bool IN_PLACE = true;"


def variant_plans(program, width: int, block_h: int, m: int):
    """``({name: (block_w, double_buffer, shared bytes)}, {name: source})``:
    each variant's launch plan, and the library source of those that need
    their own build."""
    from repro_torch.core.legalize import (
        block_smem_budget,
        launch_tile,
        tile_smem_bytes,
    )

    def planes(db):
        return program.launch_planes(streamed=True, double_buffer=db)

    def price(bw, db, planes=planes):
        return tile_smem_bytes(block_h, bw, m, halo=program.halo,
                               halo_x=program.halo_x, planes=planes(db))

    bw0, db0 = program.tile(width, block_h, m)
    bw1, db1 = launch_tile(width, block_h, m, halo=program.halo,
                           halo_x=program.halo_x, planes=planes)
    bw2 = bw0
    while bw2 > 1 and price(bw2, True) > block_smem_budget(2):
        bw2 //= 2
    plans = {
        "kernel": (bw0, db0, price(bw0, db0)),
        "one_block": (bw1, db1, price(bw1, db1)),
        "one_block_ring1": (bw1, False, price(bw1, db1)),
        "two_blocks_ring2": (bw2, True, price(bw2, True)),
        "ring1": (bw0, False, price(bw0, False)),
    }
    plans = {name: plan for i, (name, plan) in enumerate(plans.items())
             if plan not in list(plans.values())[:i]}
    srcs = {"scalar_copies": "#define TILE_COPY_SCALAR 1\n"
            + program.cuda_source()}
    if program.in_place:
        src = program.cuda_source()
        if src.count(_IN_PLACE) != 1:
            raise ValueError(f"{program.name}: no {_IN_PLACE!r} to undo")
        srcs["ping_pong"] = src.replace(_IN_PLACE,
                                        _IN_PLACE.replace("true", "false"))
        pp = lambda db: program.planes(2 + db)  # noqa: E731
        bwp, dbp = launch_tile(width, block_h, m, halo=program.halo,
                               halo_x=program.halo_x, planes=pp,
                               blocks_per_sm=2)
        plans["ping_pong"] = (bwp, dbp, price(bwp, dbp, pp))
    plans["scalar_copies"] = plans["kernel"]
    return plans, srcs


def run(program, state, regs, *, m: int, block_h: int, rounds: int = 3,
        iters: int = 20) -> dict:
    """``{name: {"ms": [...], "block_w", "double_buffer", "smem",
    "bitwise"}}`` for the streamed launch of ``program`` on the card
    tensor ``state``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.timing import ms_rounds

    _, h, w = state.shape
    plans, srcs = variant_plans(program, w, block_h, m)
    build.build_all({f"spd_{program.name}_{n}": src
                     for n, src in srcs.items()})
    lib0 = program.library()
    libs = {}
    for name, src in srcs.items():
        lib = libs[name] = build.load(f"spd_{program.name}_{name}", src)
        lib.spd_multistep_streamed.argtypes = \
            lib0.spd_multistep_streamed.argtypes
        lib.spd_multistep_streamed.restype = lib0.spd_multistep_streamed.restype
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rg = build.spd_regs(regs)
    outs, runs, res = {}, {}, {}
    for name, (bw, db, smem) in plans.items():
        lib = libs.get(name, lib0)
        out = outs[name] = torch.empty_like(state)

        def launch(lib=lib, bw=bw, db=db, smem=smem, out=out, name=name):
            build.check(lib.spd_multistep_streamed(
                state.data_ptr(), out.data_ptr(), h, w, block_h, bw, m,
                int(db), rg, smem, state.device.index, stream),
                f"spd variant {name}")

        launch()
        res[name] = {"block_w": bw, "double_buffer": db, "smem": smem}
        runs[name] = launch
    torch.cuda.synchronize()
    for name in plans:
        res[name]["bitwise"] = bool(torch.equal(outs[name], outs["kernel"]))
    for name, ms in ms_rounds(runs, rounds=rounds, iters=iters).items():
        res[name]["ms"] = ms
    return res


def report(label: str, res: dict) -> list[str]:
    return [f"  {label} {name} (block_w {r['block_w']}, ring "
            f"{2 if r['double_buffer'] else 1}): "
            f"{sum(r['ms']) / len(r['ms']):.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in r['ms'])}); {r['smem']} B "
            f"shared, bitwise == shipped: {r['bitwise']}"
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
    big = dif.DiffusionSimulation(8192, 8192)
    for line in report("diffusion 8192^2 m 4", run(
            big.kernel.program, big.state(dif.sine_init(8192, 8192)[0]),
            (0.2,), m=4, block_h=32)):
        print(line)


if __name__ == "__main__":
    main()
