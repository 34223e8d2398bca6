"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process per run: it builds the port's system for the cell, warms up
the shapes of the cell's traffic (set-up, ``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints the result as the last line of standard output; the
numbers compared, each beside its limit, are the last lines of standard
error. ``--trace 1`` records the window with ``torch.profiler`` and
reports the per-layer metrics instead of the end-to-end ones.

Exits with 2, printing no result, without a CUDA card (or fewer cards
than the cell asks for), with 3 when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` was loaded into the process, and with 4 when the
run used fewer distinct cards than the cell's ``chips``.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The checkout's root, not this directory, heads the import path (the
# harness's modules are ``bench.*``), with the port's sources after it.
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

#: Top-level modules no run may load (compared whole: ``repro_torch`` is
#: the port, ``repro`` the JAX package).
BLOCKED = ("jax", "jaxlib", "flax", "repro")


def loaded_blocked() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BLOCKED))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import find_cell, run_cell

    cell = find_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}", flush=True)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t0=T0, log=lambda msg: print(msg, flush=True))
    found = loaded_blocked()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = out["result"]
    used = result["device"]["count"]
    if used < chips:
        print(f"{args.workload} asks for {chips} card(s); the run used "
              f"{used}", file=sys.stderr)
        return 4
    print("info: " + json.dumps(out["info"], sort_keys=True), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
