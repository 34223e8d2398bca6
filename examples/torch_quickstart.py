"""Quickstart on the PyTorch port: write an SPD core (the paper's Fig. 4),
compile it, run a stream through it, inspect the hardware model, and apply
the (n, m) parallelism transforms.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``; it imports torch and
``repro_torch``, never JAX.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    Registry,
    parse_spd,
    spatial_duplicate,
    temporal_cascade,
)
from repro_torch.core.dse import FPGAModel, StreamWorkload
from repro_torch.interop import resolve_device

SPD_SOURCE = """
Name  core;                         # the paper's Fig. 4 example
Main_In  {main_i::x1,x2,x3,x4};
Main_Out {main_o::z1,z2};
Brch_In  {brch_i::bin1};
Brch_Out {brch_o::bout1};
Param cnst = 123.456;
EQU Node1, t1 = x1 * x2;            # eq (5)
EQU Node2, t2 = x3 + x4;            # eq (6)
EQU Node3, z1 = t1 - t2 * bin1;     # eq (7)
EQU Node4, z2 = t1 / t2 + cnst;     # eq (8)
DRCT (bout1) = (t2);                # eq (9)
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the streams run (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    reg = Registry()
    core = reg.compile(parse_spd(SPD_SOURCE))

    # --- run a stream through the compiled dataflow ------------------------
    t = torch.arange(8, dtype=torch.float32, device=dev)
    main_out, brch_out = core(
        {"x1": t, "x2": t + 1, "x3": t + 2, "x4": t + 3},
        {"bin1": torch.ones_like(t)},
    )
    out = {"z1": main_out["z1"], "z2": main_out["z2"],
           "bout1": brch_out["bout1"]}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    print("z1   =", out["z1"])
    print("z2   =", out["z2"])
    print("bout1=", out["bout1"])

    # --- the hardware model behind the same core ---------------------------
    rep = core.hardware_report
    print(f"\nhardware: {rep.flops} FP ops {rep.census}, "
          f"pipeline depth {rep.depth} cycles, "
          f"{rep.balance_regs} balance register-stages")

    # --- (n, m) parallelism transforms --------------------------------------
    pe = reg.compile(parse_spd("""
        Name PE;
        Main_In {mi::u};
        Main_Out {mo::u2};
        EQU N1, u2 = u + 0.25 * ( 1.0 - u * u );
    """))
    casc = temporal_cascade(pe, 4)   # m=4: one pass = 4 iterations
    dup = spatial_duplicate(pe, 2)   # n=2: two lanes per cycle
    print(f"\ntemporal cascade x4: depth {casc.hardware_report.depth} "
          f"(PE depth {pe.hardware_report.depth}), flops {casc.flops}")
    print(f"spatial duplicate x2: flops {dup.flops}, "
          f"depth {dup.hardware_report.depth}")

    x = torch.linspace(0.0, 0.9, 6, device=dev)
    (out4,) = casc.apply([x])
    seq = x
    for _ in range(4):
        (seq,) = pe.apply([seq])
    out["cascade_equal"] = bool(torch.allclose(out4, seq, rtol=1e-6))
    print("cascade == 4 sequential applications:", out["cascade_equal"])

    # --- explore the design space with the paper's platform model ----------
    w = StreamWorkload.from_report(pe.hardware_report, elems=10_000, grid_w=100)
    for pt in FPGAModel().explore(w, n_values=(1, 2), m_values=(1, 4))[:3]:
        print(f"(n={pt.n}, m={pt.m}) -> {pt.sustained_gflops:.2f} GF/s, "
              f"{pt.perf_per_watt:.3f} GF/sW {'FEASIBLE' if pt.feasible else pt.limits}")
    return out


if __name__ == "__main__":
    main()
