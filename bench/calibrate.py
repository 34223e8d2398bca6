"""Readings that set a cell's limits (run on the card, at the cell's size).

    python3 bench/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 101-104 --seconds 10

In one process, runs the cell once per seed as ``bench/run.py`` does and
prints, per seed, the widest gap of the program's state from the plain
f32 reference (the lower reading is the largest over the seeds) and, on
the control seeds, the gap of each control of :data:`bench.harness
.CONTROLS`: the same reference put in the program's place on the same
inputs, computed in bfloat16, the precision below the configuration's
float32 (the upper reading is the smallest finite one), and the gap of a
program that hands back the state it was given (``unchanged``).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="a serve cell's arrival rate in place of its mix's")
    args = ap.parse_args()
    from bench.harness import run_cell

    from bench.harness import CONTROLS, FAULTS

    CONTROLS = CONTROLS + FAULTS
    ctrl = set(seeds(args.control_seeds)) if args.control_seeds else set()
    program, control = [], {m: [] for m in CONTROLS}
    for seed in seeds(args.seeds):
        out = run_cell(args.workload, seed, args.seconds, False,
                       control=seed in ctrl, log=lambda m: None,
                       overrides=None if args.rate is None
                       else {"rate_per_s": args.rate})
        gap = out["result"]["checks"]["max_abs_gap"]["value"]
        program.append(gap)
        row = {"seed": seed, "max_abs_gap": gap,
               "correct": out["result"]["correct"],
               "info": out["info"],
               "metrics": {k: v["value"] for k, v in
                           out["result"]["metrics"].items()}}
        if seed in ctrl:
            for m in CONTROLS:
                key = f"control_{m}_max_abs_gap"
                control[m].append(out["info"][key])
                row[key] = control[m][-1]
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload,
                      "lower": max(program),
                      "upper": {m: min(v) if v else None
                                for m, v in control.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
