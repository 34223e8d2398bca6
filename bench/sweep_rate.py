"""Find the highest arrival rate a serve cell sustains (run on the card).

    python3 bench/sweep_rate.py --workload <serve cell> --rates 80,120,160 \
        --seconds 10 --seed 7

Runs the cell once per rate in one process, the mix's ``rate_per_s``
replaced, and prints per rate the latency percentiles, the requests
still queued or in flight when the window closed, and how late the load
generator ran. A rate is sustained where that backlog stays near zero and
the tail does not grow with the window; above it, ``served_mlups`` stays
at the engine's capacity.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    from bench.harness import run_cell

    for rate in (float(r) for r in args.rates.split(",")):
        out = run_cell(args.workload, args.seed, args.seconds, False,
                       overrides={"rate_per_s": rate}, log=lambda m: None)
        met = out["result"]["metrics"]
        info = out["info"]
        print(json.dumps({
            "rate_per_s": rate,
            "served_mlups": met["served_mlups"]["value"],
            "p50_ms": info["latency_p50_ms"],
            "p95_ms": info["latency_p95_ms"],
            "p99_ms": info["latency_p99_ms"],
            "max_ms": info["latency_max_ms"],
            "attempted": out["result"]["attempted"],
            "failed": out["result"]["failed"],
            "backlog_at_close": info["backlog_at_close"],
            "late_s": info["late_s"],
            "max_abs_gap": out["result"]["checks"]["max_abs_gap"]["value"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
