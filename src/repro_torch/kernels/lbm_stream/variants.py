"""Build variants of the hand-written D2Q9 kernel and time them side by side.

Each variant is ``csrc/lbm_stream.cu`` with one design choice undone by
the macros it reads, defined ahead of the source:

- ``smem_pops``: the populations in 9 more shared planes instead of the
  owners' registers (28 planes);
- ``no_prefetch``: the load slot filled and waited for at the start of
  each tile, so no copy overlaps the steps (a ring of 1 stage and no
  register-resident hand-off);
- ``scalar_copies``: every copy on the 4-byte path (``TILE_COPY_SCALAR``);
- ``threads256``: 256 threads owning 8 cells each (8 warps a block);
- ``two_blocks``: 256 threads owning 4 cells, registers sized for two
  blocks per SM, on a 16×32 tile (two 73 KB blocks share an SM);
- ``slot``: the populations in the load slot, stepped in place without
  prefetch (the instantiation a tile larger than the owners' 2,048 cells
  takes), forced at the shipped tile by owning 3 cells a thread;
- ``slot_bh256``: the shipped library at block_h 256, where every tile
  takes that instantiation (264 × 10 stripes, the widest that fit).

All are built in parallel with the library's own flags and timed (CUDA
events) in one process on the main path's launch (D2Q9 4096², m 4, block
16×64 unless the variant names its tile), beside ptxas's registers and
spills of the instantiation the launch takes and the max abs difference
from the plain version. The shipped
kernel is 512 threads owning 4 cells each in registers, a 1-slot ring.
``chip_smoke.py`` phase 5 runs :func:`run`; alone, on the machine with
the card::

    PYTHONPATH=src python -m repro_torch.kernels.lbm_stream.variants
"""

from __future__ import annotations

#: name -> (macro definitions, block_w of the timed launch, block_h).
VARIANTS = {
    "kernel": ({}, 64, 16),
    "smem_pops": ({"LBM_SMEM_POPS": 1}, 64, 16),
    "no_prefetch": ({"LBM_PREFETCH": 0}, 64, 16),
    "scalar_copies": ({"TILE_COPY_SCALAR": 1}, 64, 16),
    "threads256": ({"LBM_THREADS": 256, "LBM_CPT": 8}, 64, 16),
    "two_blocks": ({"LBM_THREADS": 256, "LBM_CPT": 4, "LBM_MIN_BLOCKS": 2},
                   32, 16),
    "slot": ({"LBM_CPT": 3}, 64, 16),
    "slot_bh256": ({}, 2, 256),
}


def owned_of(defines: dict, block_h: int, block_w: int, m: int) -> bool:
    """Whether a variant's tile takes the register instantiation."""
    cells = defines.get("LBM_THREADS", 512) * defines.get("LBM_CPT", 4)
    return (block_h + 2 * m) * (block_w + 2 * m) <= cells


def variant_source(source: str, defines: dict) -> str:
    return "".join(f"#define {k} {v}\n" for k, v in defines.items()) + source


def run(f, attr, one_tau, u_lid=0.0, *, m=4, rounds=3, iters=20):
    """Build every variant, check it against the plain version, time it;
    returns ``{name: {"ms": [...], "block_w", "regs", "spill",
    "max_abs_err"}}``. ``f`` and ``attr`` lie on the card."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.lbm_stream.lbm_stream import lbm_multistep_plain
    from repro_torch.kernels.timing import ms_rounds

    srcs = {name: variant_source(build.lbm_source(), d)
            for name, (d, _, _) in VARIANTS.items()}
    build.build_all({f"lbm_{name}": src for name, src in srcs.items()})
    h, w = f.shape[1:]
    out = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    runs, res = {}, {}
    for name, src in srcs.items():
        defines, bw, block_h = VARIANTS[name]
        so = build.library_path(f"lbm_{name}", src)
        lib = build.bind_lbm(build.load(f"lbm_{name}", src))
        smem = lib.lbm_smem_bytes(block_h, bw, m)

        def launch(lib=lib, bw=bw, block_h=block_h, smem=smem, name=name):
            build.check(lib.lbm_multistep(
                f.data_ptr(), attr.data_ptr(), out.data_ptr(), h, w,
                block_h, bw, m, one_tau, u_lid, smem, f.device.index,
                stream), f"lbm variant {name}")

        launch()
        want = lbm_multistep_plain(f, attr, one_tau, u_lid, m=m,
                                   block_h=block_h, block_w=bw)
        usage = build.ptxas_usage(so.with_suffix(".log").read_text())
        inst = "ILb1E" if owned_of(defines, block_h, bw, m) else "ILb0E"
        regs, spill = next(v for k, v in usage.items() if inst in k)
        res[name] = {"block_h": block_h, "block_w": bw, "regs": regs,
                     "spill": spill,
                     "max_abs_err": float((out - want).abs().max())}
        runs[name] = launch
    for name, ms in ms_rounds(runs, rounds=rounds, iters=iters).items():
        res[name]["ms"] = ms
    return res


def library_lookup_ms(calls: int = 50) -> dict:
    """Host ms of the wrapper's library lookup: hashing the source and
    headers on every call (``build.load``) against the binding cached
    once per process (``load_lbm_library``)."""
    import time

    from repro_torch.kernels import build

    out = {}
    for label, fn in (("hashing", lambda: build.load(
            "lbm_stream", build.lbm_source())),
            ("cached", build.load_lbm_library)):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[label] = (time.perf_counter() - t0) / calls * 1e3
    return out


def main() -> None:
    import torch

    from repro_torch.apps import lbm

    from repro_torch.kernels.timing import card_line

    if not torch.cuda.is_available():
        raise SystemExit("variants: needs the card")
    print(f"{card_line()}; D2Q9 4096^2, m 4, block_h 16")
    f, attr, _ = lbm.taylor_green_init(4096, 4096)
    for name, r in run(f, attr, 1 / 0.8).items():
        print(f"  lbm {name} ({r['block_h']}x{r['block_w']}): "
              f"{sum(r['ms']) / len(r['ms']):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in r['ms'])}); "
              f"{r['regs']} registers, {r['spill']} spill bytes; max abs "
              f"err vs plain {r['max_abs_err']:.3e}")
    print(f"  library lookup per launch, host ms: {library_lookup_ms()}")


if __name__ == "__main__":
    main()
