"""Nothing the benchmark runs loads JAX or the JAX package, or reads
``benchmarks/``.

A subprocess blocks ``jax``, ``jaxlib``, ``flax`` and ``repro`` (top-level
names compared whole, so the port ``repro_torch`` passes), records every
file it opens, imports ``bench/run.py`` and drives every cell once on the
CPU at a tiny size (a train cell's model at small widths), which loads
every module a run on the card loads but the kernels' libraries.
"""

import json
import subprocess
import sys

from bench import harness

_CHILD = r"""
import importlib.abc, json, sys
BLOCKED = ("jax", "jaxlib", "flax", "repro")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
sys.path[:0] = [ROOT, ROOT + "/src"]
import torch
torch.set_num_threads(1)
import bench.run
from bench.harness import load_spec, run_cell
tiny = {"run": {"grid": [16, 32], "steps_per_simulation": 16},
        "serve": {"grid": [16, 32], "rate_per_s": 20,
                  "steps": {"law": "log_uniform", "min": 8, "max": 32,
                            "multiple": 8}},
        "train": {"batch": 2, "seq": 16}}
for w in load_spec()["workloads"]:
    from bench.harness import find_cell
    cell = find_cell(w["name"])
    kind, config = cell.mix["kind"], None
    if kind == "train":  # a model of the configuration's kind, small
        config = {**cell.config, "d_model": 32, "n_heads": 2,
                  "n_kv_heads": 1, "head_dim": 16, "vocab": 64,
                  "moe": {**cell.config["moe"], "d_ff": 16}}
    for trace in (False, True):
        run_cell(w["name"], 2**31 + 5, 0.3, trace, device="cpu",
                 overrides=tiny[kind], config=config, log=lambda m: None)
print(json.dumps({
    "blocked": sorted({m.split(".")[0] for m in sys.modules}
                      & set(BLOCKED)),
    "benchmarks": [p for p in opened if "/benchmarks/" in p
                   or p.endswith("/benchmarks")],
    "port": "repro_torch.serve.sim" in sys.modules,
}))
"""


def test_runs_load_no_jax_and_read_no_benchmarks():
    code = f"ROOT = {str(harness.ROOT)!r}\n" + _CHILD
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"blocked": [], "benchmarks": [], "port": True}


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "lbm-tgv-4096.run",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode == 2
    assert "correct" not in out.stdout
