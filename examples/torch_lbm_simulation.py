"""End-to-end driver on the PyTorch port: lid-driven-cavity fluid
simulation through the SPD-compiled LBM pipeline, with checkpoint/restart
and an (n, m) design-space report — the paper's application, start to
finish.

    PYTHONPATH=src python examples/torch_lbm_simulation.py --steps 400 --m 4
    PYTHONPATH=src python examples/torch_lbm_simulation.py --device cpu

The port of ``examples/lbm_simulation.py``: the cavity runs through
``LBMSimulation.run`` on ``--device`` (the card by default), checkpoints
every ``--ckpt-every`` steps with ``repro_torch.train.checkpoint`` (the
JAX package's on-disk format) and restarts from the newest valid
checkpoint in ``--ckpt-dir``. The design-space report prices the H100
(``GPUModel``) where the reference prices a TPU.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.apps import lbm
from repro_torch.core.dse import FPGAModel, GPUModel, render_table
from repro_torch.interop import resolve_device
from repro_torch.train import checkpoint as ckpt


def ascii_flow(ux, uy, rows=16, cols=32):
    """Terminal visualization of the velocity field."""
    h, w = ux.shape
    chars = " .:-=+*#%@"
    sy, sx = max(h // rows, 1), max(w // cols, 1)
    mag = np.sqrt(ux.cpu().numpy() ** 2 + uy.cpu().numpy() ** 2)
    mag = mag[::sy, ::sx]
    mx = mag.max() or 1.0
    lines = []
    for r in mag[::-1]:
        lines.append("".join(chars[min(int(v / mx * 9.99), 9)] for v in r))
    return "\n".join(lines)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Run (or resume) the cavity. Returns the final populations ``f``,
    the steps ``start`` (restored) and ``done``, MLUPS (``None`` when the
    restored step leaves nothing to run), the seconds of each save and of
    the restore (``None`` without one)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--m", type=int, default=4, help="temporal cascade depth")
    ap.add_argument("--tau", type=float, default=0.7)
    ap.add_argument("--u-lid", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lbm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")

    prob = lbm.LBMProblem(args.height, args.width, tau=args.tau,
                          u_lid=args.u_lid, mode="zero")
    sim = lbm.LBMSimulation(prob, m=args.m, device=dev)
    rep = sim.hardware_report
    print(f"[lbm] SPD PE: {rep.flops} FP ops, depth {rep.depth}; "
          f"cascade m={args.m} -> depth {args.m * rep.depth}")

    f, attr = lbm.cavity_init(args.height, args.width, device=dev)
    start, restore_s = 0, None
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(args.ckpt_dir, {"f": f})
    if restored:
        start, tree, _ = restored
        f = tree["f"]
        _sync(dev)
        restore_s = time.perf_counter() - t0
        print(f"[lbm] restored checkpoint at step {start} in "
              f"{restore_s:.3f} s")

    save_s, run_s = [], 0.0
    t0 = time.perf_counter()
    done = start
    while done < args.steps:
        n = min(args.ckpt_every, args.steps - done)
        n -= n % args.m or 0
        n = max(n, args.m)
        t1 = time.perf_counter()
        f = sim.run(f, attr, n)
        _sync(dev)
        t2 = time.perf_counter()
        done += n
        ckpt.save(args.ckpt_dir, done, {"f": f})
        run_s += t2 - t1
        save_s.append(time.perf_counter() - t2)
        rho, ux, uy = lbm.macroscopics(f)
        print(f"[lbm] step {done}: mean|u|="
              f"{float(torch.mean(torch.sqrt(ux**2 + uy**2))):.5f} "
              f"mass={float(torch.sum(rho)):.1f}")
    dt = time.perf_counter() - t0
    sites = args.height * args.width * (done - start)
    mlups = sites / dt / 1e6 if sites else None
    if sites:
        print(f"[lbm] {done - start} steps in {dt:.2f}s = "
              f"{mlups:.2f} MLUPS ({dev_name})")
    else:
        print(f"[lbm] the checkpoint at step {start} in {args.ckpt_dir} "
              f"already reaches --steps {args.steps}: nothing to run (a "
              "fresh --ckpt-dir starts from step 0)")
    if save_s:
        print(f"[lbm] the steps alone: {sites / run_s / 1e6:.2f} MLUPS; "
              f"{len(save_s)} saves, {sum(save_s) / len(save_s):.3f} s "
              f"each")

    rho, ux, uy = lbm.macroscopics(f)
    print("\n[lbm] cavity flow |u| field:")
    print(ascii_flow(ux, uy))

    # --- the DSE report for this workload ----------------------------------
    w = sim.stream_workload()
    print("\n[lbm] FPGA-target design space (paper model):")
    print(render_table(FPGAModel().explore(w)[:6]))
    print("\n[lbm] H100-target temporal blocking:")
    print(render_table(GPUModel().explore(w)[:6]))
    return {"f": f, "start": start, "done": done, "mlups": mlups,
            "save_s": save_s, "restore_s": restore_s}


if __name__ == "__main__":
    main()
