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
import repro_torch.tracing
import repro_torch.core
import repro_torch.apps.diffusion
import repro_torch.apps.lbm
import repro_torch.kernels.build
import repro_torch.kernels.spd_stream
import repro_torch.kernels.lbm_stream.ops
import repro_torch.core.distribute
import repro_torch.models.registry
import repro_torch.models.mamba2
import repro_torch.models.zamba2
import repro_torch.models.transformer
import repro_torch.models.layers
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
import repro_torch.core.program
import repro_torch.apps.advection_diffusion
import repro_torch.serve.sim
import repro_torch.train.checkpoint
import repro_torch.train.optimizer
import repro_torch.train.data
import repro_torch.train.loop
import repro_torch.models.xlstm
import repro_torch.launch.train
import repro_torch.launch.mesh
import repro_torch.parallel
import repro_torch.parallel.hints
import repro_torch.parallel.sharding
import repro_torch.parallel.compression
import repro_torch.parallel.pipeline
import repro_torch.parallel.moe_ep
import repro_torch.launch.hlo_cost
import repro_torch.launch.dryrun
import importlib.util, os
examples = os.path.join(os.path.dirname(repro_torch.__file__), "..", "..",
                        "examples")
for name in ("torch_quickstart", "torch_lbm_simulation", "torch_dse_explore",
             "torch_train_lm", "torch_serve_lm"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(examples, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
from repro_torch.apps import advection_diffusion as ad
asim = ad.AdvectionDiffusionSimulation(16, 32, device="cpu")
blob = ad.blob_init(16, 32, device="cpu")
assert asim.run(blob, 2, fusion="1+1", block_h=8).equal(
    asim.run(blob, 2, fusion="2", block_h=8))
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
from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest
eng = SimEngine(PlanResolver(budget=0, b_values=(2,), bh_values=(8,),
                             m_values=(2,)), device="cpu")
for rid in range(2):
    eng.submit(SimRequest(rid=rid, core=sim.kernel, state=sim.state(u0),
                          steps=4, regs=(0.2,)))
assert [c.steps for c in eng.run_until_drained()] == [4, 4]
assert eng.stats()["occupancy"] == {"2": 2}
import torch
from repro_torch.configs import get_arch
from repro_torch.models import registry
bundle = registry.build(get_arch("qwen3-8b").reduced(), device="cpu")
model = bundle.init(torch.Generator().manual_seed(0))
nxt = bundle.make_prefill_step()(model, {"tokens": torch.tensor([[1, 2, 3]])})
assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
hyb = get_arch("zamba2-7b").reduced()
assert hyb.num_params() == 720064
bundle = registry.build(hyb, device="cpu")
model = bundle.init(torch.Generator().manual_seed(0))
nxt = bundle.make_prefill_step()(model, {"tokens": torch.tensor([[1, 2, 3]])})
assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
from repro_torch.configs import ShapeConfig
from repro_torch.models import transformer as tfm
for name in ("llava-next-34b", "whisper-medium"):
    cfg = get_arch(name).reduced()
    bundle = registry.build(cfg, device="cpu")
    model = bundle.init(torch.Generator().manual_seed(0))
    batch = registry.make_batch(cfg, ShapeConfig("p", 32, 1, "prefill"),
                                seed=0, device="cpu")
    nxt = bundle.make_prefill_step()(model, batch)
    assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
cache = tfm.prime_cross_cache(model, bundle.cache_init(1, 8),
                              tfm.encode(model, batch["frames"]))
lg, _ = bundle.decode(model, batch["tokens"][:, :1], cache, 0)
assert lg.shape == (1, 1, 512)
for name in ("mixtral-8x7b", "kimi-k2-1t-a32b"):
    bundle = registry.build(get_arch(name).reduced(), device="cpu")
    model = bundle.init(torch.Generator().manual_seed(0))
    nxt = bundle.make_prefill_step()(model,
                                     {"tokens": torch.tensor([[1, 2, 3]])})
    assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
art = dryrun.dry_run(get_arch("qwen3-8b").reduced(),
                     ShapeConfig("t", 16, 2, "train"),
                     Mesh((1, 1), ("data", "model"), [torch.device("meta")]),
                     num_microbatches=2)
assert art["hlo_cost"]["flops"] > 0 and art["hlo_cost"]["n_whiles"] == 1
import tempfile
from repro_torch.train import checkpoint as ckpt
with tempfile.TemporaryDirectory() as d:
    tree = {"w": torch.ones(3, dtype=torch.bfloat16), "s": [torch.zeros(2)]}
    ckpt.save(d, 1, tree)
    step, got, _ = ckpt.restore_latest(d, tree)
    assert step == 1 and torch.equal(got["w"], tree["w"])
ssm = get_arch("xlstm-125m").reduced()
assert ssm.num_params() == 728448
bundle = registry.build(ssm, device="cpu")
model = bundle.init(torch.Generator().manual_seed(0))
nxt = bundle.make_prefill_step()(model, {"tokens": torch.tensor([[1, 2, 3]])})
assert nxt.shape == (1, 512) and bool(torch.isfinite(nxt).all())
from repro_torch.interop import param_tree
from repro_torch.train.optimizer import AdamWConfig, init_state
opt = AdamWConfig()
state = init_state(opt, param_tree(model))
batch = {"tokens": torch.tensor([[1, 2, 3]]), "labels": torch.tensor([[2, 3, 4]])}
_, state, metrics = bundle.make_train_step(opt)(model, state, batch)
assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.hints import sharding_hints
from repro_torch.parallel.pipeline import pipelined_forward, stack_stage_params
mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
moe_cfg = get_arch("mixtral-8x7b").reduced()
bundle = registry.build(moe_cfg, device="cpu")
model = bundle.init(torch.Generator().manual_seed(0))
with sharding_hints(ep="model", ep_size=4, dp=("data",), dp_size=2, a2a=mesh):
    nxt = bundle.make_prefill_step()(model, {"tokens": torch.ones((2, 4), dtype=torch.int64)})
assert nxt.shape == (2, 512) and bool(torch.isfinite(nxt).all())
run = pipelined_forward(make_mesh((2,), ("stage",), ["cpu"] * 2),
                        lambda w, x: x @ w[0])
assert run(stack_stage_params(torch.eye(3)[None].repeat(2, 1, 1), 2),
           torch.ones(3, 1, 3)).equal(torch.ones(3, 1, 3))
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
    files += [os.path.join(ROOT, "examples", n)
              for n in os.listdir(os.path.join(ROOT, "examples"))
              if n.startswith("torch_") and n.endswith(".py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                     if pat.match(line)]
    assert not hits, hits
