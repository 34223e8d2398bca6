"""Readings that set a cell's limits (run on the card, at the cell's size).

    python3 bench/calibrate.py --workload <cell> --seeds 101-112 \
        --control-seeds 101-104 [--faults top1,half_batch,unchanged] \
        --seconds 10

In one process, runs the cell once per seed as ``bench/run.py`` does and
prints, per seed, each number the cell compares (the lower reading of
each is the largest over the seeds) and, on the control seeds, the same
number of each control: the plain reference put in the program's place
on the same inputs, in a precision below the configuration's (a run or
serve cell's :data:`bench.harness.CONTROLS` and the program that hands
back the state it was given, ``unchanged``; a train cell's
:data:`bench.harness.TRAIN_CONTROLS`). ``--faults`` (a train cell) also
runs the program on each control seed with each fault of
:data:`bench.apps.lm_train.FAULTS` planted. The upper reading of a
number is the smallest finite one of a control or a fault.
"""

import argparse
import contextlib
import importlib
import json
import math
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
    ap.add_argument("--faults", default="",
                    help="faults to plant on the control seeds (train)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="a serve cell's arrival rate in place of its mix's")
    args = ap.parse_args()
    from bench.harness import find_cell, run_cell

    ctrl = set(seeds(args.control_seeds)) if args.control_seeds else set()
    faults = [f for f in args.faults.split(",") if f]
    plant = None
    if faults:
        app = find_cell(args.workload).config["app"]
        plant = importlib.import_module(f"bench.apps.{app}").plant
    overrides = None if args.rate is None else {"rate_per_s": args.rate}
    lower, upper = {}, {}

    def run(seed, control, fault=None):
        with plant(fault) if fault else contextlib.nullcontext():
            return run_cell(args.workload, seed, args.seconds, False,
                            control=control, log=lambda m: None,
                            overrides=overrides)

    for seed in seeds(args.seeds):
        out = run(seed, seed in ctrl)
        checks = {k: c["value"] for k, c in out["result"]["checks"].items()}
        for k, v in checks.items():
            lower[k] = max(lower.get(k, 0.0), v)
        row = {"seed": seed, "checks": checks,
               "correct": out["result"]["correct"],
               "device": out["result"]["device"], "info": out["info"],
               "metrics": {k: v["value"] for k, v in
                           out["result"]["metrics"].items()}}
        for key, v in out["info"].items():
            if key.startswith("control_"):
                upper.setdefault(key, []).append(v)
        print(json.dumps(row), flush=True)
        if seed in ctrl:
            for fault in faults:
                got = run(seed, False, fault)["result"]["checks"]
                vals = {k: c["value"] for k, c in got.items()}
                for k, v in vals.items():
                    upper.setdefault(f"fault_{fault}_{k}", []).append(v)
                print(json.dumps({"seed": seed, "fault": fault,
                                  "checks": vals}), flush=True)
    print(json.dumps({
        "workload": args.workload, "lower": lower,
        "upper": {k: min((x for x in v if math.isfinite(x)), default=None)
                  for k, v in upper.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
