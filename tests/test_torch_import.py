"""The port stands alone: it imports neither JAX nor the ``repro`` package."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[name]
sys.meta_path.insert(0, _Block())
import repro_torch
import repro_torch.interop
import repro_torch.core
import repro_torch.apps.diffusion
import repro_torch.apps.lbm
import repro_torch.kernels.build
import repro_torch.kernels.spd_stream
import repro_torch.kernels.lbm_stream.ops
import repro_torch.core.distribute
import repro_torch.models.registry
import repro_torch.serve.engine
import repro_torch.kernels.flash_attention.ops
import repro_torch.launch.serve
import repro_torch.core.dse
import repro_torch.core.planner
import repro_torch.core.measure
import repro_torch.core.explorer
import repro_torch.core.search
import repro_torch.core.search.runner
import repro_torch.core.search.strategies
import repro_torch.core.search.surrogate
import repro_torch.core.search.study
import repro_torch.cli
from repro_torch.apps import diffusion
sim = diffusion.DiffusionSimulation(16, 32, device="cpu")
u0, _ = diffusion.sine_init(16, 32, device="cpu")
assert sim.run(u0, 4, m=2, block_h=8).shape == (16, 32)
assert sim.run(u0, 4, m=2, block_h=4, d=2).equal(sim.run(u0, 4, m=2,
                                                         block_h=4))
ex = sim.explorer()
res = ex.search(ex.sweep_gpu(bh_values=(8,), m_values=(1, 2), d_values=(1,)),
                sim.state(u0), (0.2,), reps=1, calibrate=False)
assert res.executed and res.best.interpret
import torch
from repro_torch.configs import get_arch
from repro_torch.models import registry
bundle = registry.build(get_arch("qwen3-8b").reduced(), device="cpu")
model = bundle.init(torch.Generator().manual_seed(0))
nxt = bundle.make_prefill_step()(model, {"tokens": torch.tensor([[1, 2, 3]])})
assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_import_lines_name_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                     if pat.match(line)]
    assert not hits, hits
