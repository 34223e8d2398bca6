"""``correct`` catches a broken timed path, and the control fails the limit.

Each test drives a whole run of a cell on the CPU at a tiny size, the
harness's look for a card skipped (``device="cpu"``: the stream kernels
run their plain versions), with a fault planted in the port underneath:
the kernel handing back the state it was given, one word of its answer
altered, (in a batched launch) half of the batch left out, or (in the
mesh cell, its four shards on ``["cpu"] * 4``) the exchange between
shards left out. A sound run comes out correct; each fault, and the
lower-precision control put in the program's place, comes out not
correct.
"""

import pytest

from bench import harness
from repro_torch.core.codegen import StreamKernel
from repro_torch.core.distribute import ShardBuffers, ShardedStreamKernel

SEED = 2**31 + 11
TINY = {
    "lbm-tgv-4096.run": {"grid": [32, 32], "steps_per_simulation": 64},
    "diffusion-8192.run": {"grid": [32, 32], "steps_per_simulation": 64},
    "lbm-cavity-300x720.serve": {
        "grid": [24, 32], "rate_per_s": 40,
        "steps": {"law": "log_uniform", "min": 16, "max": 64,
                  "multiple": 8}},
    "diffusion-2048.serve": {
        "grid": [24, 32], "rate_per_s": 40,
        "steps": {"law": "log_uniform", "min": 16, "max": 64,
                  "multiple": 8}},
    "lbm-tgv-8192.mesh4": {"grid": [64, 64], "steps_per_simulation": 32},
}
CELLS = list(TINY)
RUN = [c for c in CELLS if c.endswith(".run")]
MESH = [c for c in CELLS if c.endswith(".mesh4")]
SERVE = [c for c in CELLS if c.endswith(".serve")]


def run(cell, seconds=1.0, rate=None, **kw):
    mix = dict(TINY[cell])
    if rate is not None:
        mix["rate_per_s"] = rate
    return harness.run_cell(cell, SEED, seconds, False, device="cpu",
                            overrides=mix, log=lambda m: None, **kw)


def alter(out):
    out = out.clone()
    out.view(-1)[out.numel() // 3] += 1e-2
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run(cell)["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    out = run(cell, control=True)
    limit = out["result"]["checks"]["max_abs_gap"]["limit"]
    for mode in harness.CONTROLS:
        assert out["info"][f"control_{mode}_max_abs_gap"] > limit, mode


@pytest.mark.parametrize("cell", RUN)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    real = StreamKernel.run_for_point

    def broken(self, state, regs=(), *, point, steps=None):
        out, plan = real(self, state, regs, point=point, steps=steps)
        return (state.clone() if fault == "unchanged" else alter(out)), plan

    monkeypatch.setattr(StreamKernel, "run_for_point", broken)
    assert not run(cell)["result"]["correct"]


@pytest.mark.parametrize("cell", MESH)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "no_exchange"])
def test_a_broken_mesh_is_not_correct(cell, fault, monkeypatch):
    real = ShardedStreamKernel.run_for_point

    def broken(self, state, regs=(), *, point, steps=None):
        out, plan = real(self, state, regs, point=point, steps=steps)
        return (state.clone() if fault == "unchanged" else alter(out)), plan

    if fault == "no_exchange":
        for name in ("exchange_x", "exchange_y"):
            monkeypatch.setattr(ShardBuffers, name, lambda self: None)
    else:
        monkeypatch.setattr(ShardedStreamKernel, "run_for_point", broken)
    assert not run(cell)["result"]["correct"]


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_batch"])
def test_a_broken_engine_is_not_correct(cell, fault, monkeypatch):
    real = StreamKernel.__call__
    widths = []

    def broken(self, state, regs=(), **kw):
        out = real(self, state, regs, **kw)
        widths.append(state.shape[0] if state.dim() == 4 else 1)
        if fault == "unchanged":
            return state.clone()
        if fault == "altered":
            return alter(out)
        if state.dim() == 4:
            half = state.shape[0] // 2
            out = out.clone()
            out[half:] = state[half:]
        return out

    monkeypatch.setattr(StreamKernel, "__call__", broken)
    config, rate = None, None
    if fault == "half_batch":
        # The model's plan serves one member a launch: widths of four, and
        # a load that keeps them full, make batches.
        cell_cfg = harness.find_cell(cell).config
        config, rate = {**cell_cfg, "serve_b": [4]}, 400
    res = run(cell, seconds=2.0, rate=rate, config=config)["result"]
    assert not res["correct"]
    if fault == "half_batch":
        assert max(widths) > 1
