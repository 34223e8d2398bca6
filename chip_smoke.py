#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it imports nothing of JAX or of the ``repro``
package. Phases, each printed as it ends; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the parallel ``nvcc`` build of every kernel, the
   flash library's ptxas registers and spills and SASS census (wgmma,
   TMA and mbarrier instructions), and the registers and spills of every
   kernel of the two stream libraries (generated SPD, hand-written LBM);
2. each kernel against its plain torch version on the card at 512×1024,
   plus the bitwise invariances (streamed == declarative, double_buffer on
   == off, two tilings agree), the generated uLBM PE against the
   hand-written LBM kernel, both halo launches on a ring shard and on a
   width-extended shard, and a (2, 2) mesh on ``["cuda:0"] * 4`` against
   the single-device run;
3. the main path at real size, with every launch count set to 0 just
   before and read just after: diffusion 8192² (64 steps, m 4), the
   paper's 300×720 LBM grid through ``run_for_point`` at m 4 (and its
   declarative and hand-written twins), LBM 4096² through ``run_blocked``
   (and the hand-written kernel); each run is held to
   ``StreamKernel.reference`` on the card;
3b. spatial parallelism on one card, counts set to 0 again: the same
   inputs through ``ShardedStreamKernel`` on a device list that repeats
   ``cuda:0`` — diffusion 8192² on a (4, 1) ring and a (2, 2) mesh, overlap
   on and off (and the declarative twin), uLBM 4096² on a (2, 2) mesh, the
   300×720 cavity through ``run_for_point`` on a (2, 2) mesh — each
   bitwise equal to its single-device run of phase 3, with its wall time,
   MLUPS and the exchange's time apart from the launches;
4. physics through the kernels: Taylor-Green decay and the diffusion sine
   mode;
6. LM serving (run before phase 5): (a) the flash-attention kernel
   against its plain version on the reference's test matrix at D 128 in
   f32 and bf16, two block shapes, and the Qwen3-8B prefill shape; (b)
   Qwen3-8B at full width in bf16 (random weights from a seeded
   generator): the prefill step on 4 prompts of 2048 tokens, flash
   launches counted from 0, next-token logits held to the same model with
   plain attention; (c) the continuous-batching engine at full width, 8
   requests on 4 slots; (d) greedy consistency at full width and 4
   layers in f32: engine tokens == argmax of the kernel-run forward, and
   decode logits == forward logits;
5. at the main-path shapes, each kernel held to its plain version again
   and timed (CUDA events) against its bound, its plain version and, for
   diffusion and flash attention, one PyTorch call (``library_ms``); the
   halo kernels at one shard of the phase-3b runs; flash attention on
   contiguous q/k/v and on the prefill's head-split views, with TFLOP/s
   and the share of its bound; then the two stencil kernels' design
   choices side by side (``kernels/lbm_stream/variants.py``,
   ``kernels/spd_stream/variants.py``: three rounds after a warm-up);
7. the model → measure → search loop on the card (docs/port.md §dse),
   stream launch counts set to 0 just before and read just after: (a)
   ``python -m repro_torch.cli explore --devices 1 --topk 1 --strategy
   halving --budget 12 --no-calibrate`` in-process, twice, with its
   measurement cache in a temporary directory — section 1's best (1, 4),
   every executed point feasible, at most 12 live measurements per app,
   none on the repeat; (b) the two calibration probes (the FMA-chain
   kernel's GF/s, whose first build lands in the warm-up, and the 1 GiB
   bandwidth probe against 3.35 TB/s) and the exhaustive frontier search
   (k 3, calibrated) of the uLBM PE at 4096² and diffusion at 8192²,
   one line per executed plan, the best plan run again and held to
   ``StreamKernel.reference``; (c) a seeded TPE study (budget 6) at
   4096² and its resume, which measures nothing and keeps the trial
   sequence; (d) the FMA-chain kernel against its plain version, bitwise.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: Kernel vs its plain version: both round the same f32 operations in the
#: same order (nvcc with -fmad=false, torch eager), so only a fault shows.
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
#: Full-grid runs against StreamKernel.reference: the reference runs the
#: same operations untiled; stated at the CPU tests' f32 tolerance.
RUN_TOL = dict(rtol=2e-5, atol=1e-6)
#: Generated uLBM PE vs hand-written kernel: the two sum rho's nine terms
#: the same way but route bounce-back through different op trees
#: (tests/test_codegen.py holds the JAX pair to the same numbers).
GEN_VS_HAND_TOL = dict(rtol=2e-5, atol=1e-7)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(msg: str) -> None:
    print(msg, flush=True)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(name, got, want, tol) -> float:
    import torch

    err = max_err(got, want)
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    if not torch.allclose(got, want, **tol):
        fail(f"{name}: max abs err {err} outside rtol {tol['rtol']} "
             f"atol {tol['atol']}")
    phase(f"  {name}: max abs err {err:.3e} (rtol {tol['rtol']}, "
          f"atol {tol['atol']})")
    return err


def check_equal(name, a, b) -> None:
    import torch

    if not torch.equal(a, b):
        fail(f"{name}: not bitwise equal (max abs err {max_err(a, b)})")
    phase(f"  {name}: bitwise equal")


def cuda_ms(fn, iters: int = 10):
    """Mean ms per call by CUDA events, after one warm-up call, and the
    last call's result."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def timed_pair(name, kernel_fn, plain_fn, plain_iters=2, iters=10):
    """Time a kernel and its plain version on the same main-path inputs
    and hold the kernel's result to the plain one."""
    ms, got = cuda_ms(kernel_fn, iters)
    plain_ms, want = cuda_ms(plain_fn, plain_iters)
    err = check_close(f"{name} vs plain", got, want, KERNEL_TOL)
    return ms, plain_ms, err


def card_peaks(name: str) -> tuple[float, float, float]:
    """(HBM bytes/s, FP32 non-tensor FLOP/s, bf16 dense tensor-core
    FLOP/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12  # H100 SXM (80GB HBM3)


#: Flash kernel vs its plain version on the same card inputs: f32 at the
#: JAX kernel test's 2e-3 (scalar FMAs summed in another order), bf16 at
#: its 2e-2 (bf16 probabilities in P·V, bf16 output rounding).
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: The reference's flash test matrix (tests/test_kernels.py), at D 128:
#: (B, Hq, Hkv, Sq, Sk, causal, window).
FLASH_MATRIX = {
    "mha": (1, 2, 2, 128, 128, True, 0),
    "mqa": (2, 4, 1, 128, 128, True, 0),
    "gqa_prefix": (1, 4, 2, 64, 256, True, 0),
    "bidirectional": (1, 2, 2, 128, 128, False, 0),
    "window": (1, 2, 2, 256, 256, True, 64),
}
#: The Qwen3-8B prefill: prompts x tokens, and its attention launch shape.
PREFILL = (4, 2048)
#: Full-width bf16 prefill through the kernel against the same model with
#: plain attention: both round each layer's attention output to bf16 but
#: at other places inside, and 36 layers carry the difference to the
#: logits; held as a relative L2 error of the next-token logits.
PREFILL_REL_L2 = 5e-2
#: Decode logits against forward logits (tests/test_archs.py).
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)


def flash_census(build) -> None:
    """Phase 1's view of the compiled flash library: ptxas's registers and
    spill bytes for each bf16 kernel, and the SASS counts of the Hopper
    instructions (HGMMA: wgmma, UTMALDG: TMA loads, SYNCS: mbarriers).
    Fails when the Hopper kernels spill or lack wgmma or TMA."""
    import re
    import shutil

    so = build.library_path("flash_attention", build.flash_source())
    kernels, name = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels.setdefault(name, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, {})["regs"] = int(m.group(1))
    hopper = 0
    for name, info in sorted(kernels.items()):
        m = re.search(r"(hopper|simple)12(flash|probe)_kernelI.*?Li(\d+)E",
                      name)
        if not m or (m.group(1) == "simple" and "bfloat16" not in name):
            continue
        label = f"{m.group(1)}::{m.group(2)}_kernel<bf16, D {m.group(3)}>"
        phase(f"  ptxas {label}: {info.get('regs')} registers, "
              f"{info.get('spill')} spill bytes")
        if m.group(1) == "hopper" and m.group(2) == "flash":
            hopper += 1
            if info.get("spill") != 0:
                fail(f"{label} spills {info.get('spill')} bytes")
    if hopper != 2:
        fail(f"ptxas log lists {hopper} Hopper flash kernels, expected 2")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG", "SYNCS")}
    phase(f"  flash library SASS census: {counts}")
    if not counts["HGMMA"] or not counts["UTMALDG"]:
        fail(f"flash library lacks wgmma or TMA instructions: {counts}")


def stream_census(build, sources: dict) -> None:
    """Phase 1's view of the stream libraries: ptxas's registers and spill
    bytes for every kernel; fails on a spill."""
    for lib, src in sources.items():
        log = build.library_path(lib, src).with_suffix(".log").read_text()
        usage = build.ptxas_usage(log)
        if not usage:
            fail(f"ptxas log of {lib} lists no kernel")
        for name, (regs, spill) in sorted(usage.items()):
            phase(f"  ptxas {lib} {name}: {regs} registers, {spill} spill "
                  "bytes")
            if spill:
                fail(f"{lib} {name} spills {spill} bytes")


def lm_serving(cfg) -> dict:
    """Phase 6: the flash kernel against its plain version, the prefill
    and the engine of ``cfg`` at full width, and the f32 greedy check.
    Returns the numbers phase 5's flash row needs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeEngine

    phase("phase 6: LM serving")
    dev = "cuda"
    out = {"errs": []}
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        mk = lambda h, s: torch.randn(  # noqa: E731
            (b, h, s, d), generator=g, device=dev).to(dtype)
        return mk(hq, sq), mk(hkv, sk), mk(hkv, sk)

    # 6a. the kernel against its plain version
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for case, (b, hq, hkv, sq, sk, causal, window) in FLASH_MATRIX.items():
            q, k, v = qkv(b, hq, hkv, sq, sk, 128, dtype)
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            out["errs"].append(check_close(
                f"flash {case} {dname}", got.float(), want.float(),
                FLASH_TOL[dname]))
        q, k, v = qkv(1, 2, 2, 128, 256, 128, dtype)
        a = flash_attention(q, k, v, block_q=64, block_k=64)
        b = flash_attention(q, k, v, block_q=128, block_k=128)
        check_equal(f"flash {dname} blocks 64x64 == 128x128", a, b)
        out["errs"].append(check_close(
            f"flash {dname} blocks 64x64 vs plain", a.float(),
            flash_attention_plain(q, k, v).float(), FLASH_TOL[dname]))
    b, s = PREFILL
    q, k, v = qkv(b, cfg.n_heads, cfg.n_kv_heads, s, s, cfg.head_dim,
                  torch.bfloat16)
    out["errs"].append(check_close(
        f"flash prefill shape q {tuple(q.shape)} kv {tuple(k.shape)} bf16",
        flash_attention(q, k, v).float(),
        flash_attention_plain(q, k, v).float(), FLASH_TOL["bfloat16"]))
    out["qkv"] = (q, k, v)

    # 6b. the prefill step at full width, bf16
    torch.cuda.reset_peak_memory_stats()
    bundle = registry.build(cfg, device=dev)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    prefill = bundle.make_prefill_step()
    tok_gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, PREFILL, generator=tok_gen,
                           device=dev)
    prefill(model, {"tokens": tokens[:1, :128]})  # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    nxt = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches"] = flash_attention.launches
    phase(f"  launches on the LM prefill path: "
          f"{{'flash_attention': {out['launches']}}}")
    if out["launches"] != cfg.n_layers:
        fail(f"flash_attention launched {out['launches']} times in the "
             f"prefill, expected {cfg.n_layers}")
    if nxt.shape != (b, cfg.vocab) or not torch.isfinite(nxt).all():
        fail(f"prefill logits: shape {tuple(nxt.shape)} or non-finite")
    want = plain.make_prefill_step()(model, {"tokens": tokens})
    rel = float((nxt.float() - want.float()).norm() / want.float().norm())
    agree = int((nxt.argmax(-1) == want.argmax(-1)).sum())
    phase(f"  {cfg.name} prefill {b}x{s}: {wall * 1e3:.1f} ms, "
          f"{b * s / wall:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; next-token "
          f"logits vs plain attention: rel L2 {rel:.3e} (<= "
          f"{PREFILL_REL_L2}), max abs err {max_err(nxt, want):.3e}, "
          f"argmax agrees on {agree}/{b}")
    if not rel <= PREFILL_REL_L2:
        fail(f"prefill logits rel L2 {rel} vs plain attention")
    del want

    # 6c. the engine at full width, bf16
    rng = np.random.default_rng(0)
    eng = ServeEngine(bundle, model, max_batch=4, max_seq=256)
    for rid in range(8):
        prompt = rng.integers(1, cfg.vocab, rng.integers(4, 17)).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(c.rid for c in done) != list(range(8)) or not all(
            len(c.tokens) == 16 and all(0 <= t < cfg.vocab for t in c.tokens)
            for c in done):
        fail(f"engine completions malformed: {[(c.rid, c.tokens) for c in done]}")
    phase(f"  engine: 8 requests x 16 tokens on 4 slots in "
          f"{wall * 1e3:.1f} ms, {8 * 16 / wall:.1f} decode tokens/s, "
          f"{eng.decode_calls} decode steps ({eng.decode_calls / wall:.1f} "
          "steps/s)")
    # Ten full-batch steps alone: the host's time to enqueue them against
    # the time until the card is done (equal when the host bounds the
    # step), beside the step's bound, reading every weight once.
    tok = torch.ones((4, 1), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        bundle.decode(model, tok, eng.cache, 200 + i)
    enqueue = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 10
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    phase(f"  one decode step (4 slots, cache 256): {step * 1e3:.2f} ms, "
          f"host enqueue {enqueue * 1e3:.2f} ms, weight-read bound "
          f"{weights / card_peaks(torch.cuda.get_device_name(0))[0] * 1e3:.2f}"
          " ms")
    del eng, model, bundle, plain
    torch.cuda.empty_cache()

    # 6d. greedy consistency at full width, 4 layers, f32
    f32 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    bundle = registry.build(f32, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(2))
    prompts = [rng.integers(1, cfg.vocab, 6).tolist() for _ in range(2)]
    eng = ServeEngine(bundle, model, max_batch=2, max_seq=64)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=8))
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    for rid, p in enumerate(prompts):
        seq = list(p)
        for t in done[rid]:
            logits = bundle.forward(model, {"tokens": torch.tensor(
                [seq], device=dev)})
            if t != int(logits[0, -1].argmax()):
                fail(f"f32 engine request {rid}: token {t} != forward "
                     f"argmax after {seq}")
            seq.append(t)
    phase(f"  f32 4-layer engine, 2 slots at one position: {done} == "
          "argmax of the kernel-run forward")
    toks = torch.tensor([prompts[0] + done[0], prompts[1] + done[1]],
                        device=dev)
    n = toks.shape[1]
    full = bundle.forward(model, {"tokens": toks})
    cache = bundle.cache_init(2, n)
    steps = []
    for t in range(n):
        lg, cache = bundle.decode(model, toks[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    check_close(f"f32 decode logits vs forward logits over {n} positions",
                torch.stack(steps, dim=1), full, DECODE_TOL)
    del model, bundle, cache, full
    torch.cuda.empty_cache()
    return out


def dse_loop(kind: str, hbm: float, fp32: float) -> None:
    """Phase 7: the model → measure → search loop on the card."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch import cli
    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm
    from repro_torch.core import measure
    from repro_torch.core.dse import GPUModel
    from repro_torch.core.search import ExhaustiveSearch, Study, TPESearch
    from repro_torch.kernels import build
    from repro_torch.kernels.spd_stream.spd_stream import spd_multistep_plain
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_streamed,
    )

    phase(f"phase 7: model -> measure -> search on the card ({kind})")
    t7 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dse-")
    model = GPUModel()

    def feasible(workload, e) -> bool:
        return model.evaluate(workload, e["block_h"], e["m"], d=e["d"],
                              double_buffer=e["double_buffer"]).feasible

    try:
        spd_multistep_streamed.launches = 0
        # 7a. the CLI, twice: the repeat is served by the cache.
        os.environ["REPRO_TORCH_MEASURE_CACHE"] = os.path.join(tmp, "a.json")
        argv = ["explore", "--devices", "1", "--topk", "1", "--strategy",
                "halving", "--budget", "12", "--json",
                os.path.join(tmp, "a-report.json"), "--no-calibrate"]
        runs = []
        for i in range(2):
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                runs.append(cli.main(argv))
            wall = time.perf_counter() - t0
            lines = text.getvalue().splitlines()
            for line in lines:
                if line.startswith(("-> best", "| block_h", "(strategy",
                                    "(measurement cache")) or (
                        i == 0 and line.startswith("| ") and " live |" in line):
                    phase(f"  cli run {i + 1}: {line}")
            phase(f"  cli run {i + 1}: {wall:.2f} s")
        first, again = runs
        if (first["fpga"]["best"]["n"], first["fpga"]["best"]["m"]) != (1, 4):
            fail(f"cli section 1 best {first['fpga']['best']}, expected "
                 "(1, 4)")
        workloads = {
            "lbm": lbm.LBMSimulation(lbm.LBMProblem(256, 128))
            .stream_workload(),
            "diffusion": dif.DiffusionSimulation(256, 128).explorer().workload,
        }
        for app, workload in workloads.items():
            spent, spent2 = (first[app]["budget_spent"],
                             again[app]["budget_spent"])
            if not first[app]["executed"] or not 0 < spent <= 12:
                fail(f"cli {app}: {spent} live measurements for "
                     f"{len(first[app]['executed'])} points (budget 12)")
            if spent2 != 0:
                fail(f"cli {app} repeat spent {spent2} live measurements")
            for e in first[app]["executed"] + again[app]["executed"]:
                if e["interpret"] or not feasible(workload, e):
                    fail(f"cli {app}: executed point {e} is infeasible or "
                         "ran the plain version")
            phase(f"  cli {app}: budget_spent {spent} <= 12, repeat "
                  f"{spent2}, declined {first[app]['declined']}, every "
                  "executed point feasible")

        # 7b. the probes, then the explorer at the port's measured sizes.
        cal = measure.calibrate_backend("cuda", shape=(8192, 8192), m=8)
        phase(f"  probe FMA-chain core 8192^2 m 8: {cal.elem_gflops:.1f} "
              f"GF/s ({cal.elem_gflops / (fp32 / 1e9):.1%} of "
              f"{fp32 / 1e12:.0f} TFLOP/s FP32); bandwidth probe "
              f"(a + 1.0, {cal.detail['mem_mbytes']} MiB): "
              f"{cal.mem_gbs:.1f} GB/s "
              f"({cal.mem_gbs / (hbm / 1e9):.1%} of {hbm / 1e12:.2f} TB/s)")
        dsim = dif.DiffusionSimulation(8192, 8192)
        tsim = lbm.LBMSimulation(lbm.LBMProblem(4096, 4096))
        f0, attr, _ = lbm.taylor_green_init(4096, 4096)
        cases = (
            ("uLBM PE 4096^2 TGV", tsim.explorer(), tsim.stream_kernel(),
             tsim.stream_state(f0, attr), tsim.stream_regs()),
            ("diffusion 8192^2", dsim.explorer(), dsim.kernel,
             dsim.state(dif.sine_init(8192, 8192)[0]), (dsim.alpha,)),
        )
        for label, ex, kern, state, regs in cases:
            sweep = ex.sweep_gpu(bh_values=(8, 16, 32, 64),
                                 m_values=(1, 2, 4, 8), d_values=(1,))
            res = ex.search(sweep, state, regs,
                            strategy=ExhaustiveSearch(k=3,
                                                      frontier_only=True),
                            calibrate=True, cache=os.path.join(tmp, "b.json"))
            if not res.executed:
                fail(f"{label}: the search executed no point")
            for e in res.executed:
                bw, db = kern.tile(state.shape[2], e.block_h, e.m,
                                   double_buffer=e.double_buffer)
                phase(f"  {label} plan (block_h {e.block_h}, m {e.m}, "
                      f"block_w {bw}, prefetch {db}): model "
                      f"{e.predicted_gflops:.1f}, calibrated "
                      f"{e.calibrated_gflops:.1f}, measured "
                      f"{e.measured_gflops:.1f} GF/s, "
                      f"{e.measured_mlups:.1f} MLUPS, rel_error "
                      f"{e.rel_error:+.3f} ({e.wall_s * 1e3:.4f} ms, "
                      f"{'cache' if e.cached else 'live'})")
                if e.interpret or not feasible(ex.workload, e.as_dict()):
                    fail(f"{label}: executed point {e.as_dict()} is "
                         "infeasible or ran the plain version")
            best = res.best
            out = kern.run_blocked(state, regs, steps=best.steps, m=best.m,
                                   block_h=best.block_h,
                                   double_buffer=best.double_buffer)
            check_close(f"{label} best plan (block_h {best.block_h}, m "
                        f"{best.m}) vs reference", out,
                        kern.reference(state, regs, m=best.steps), RUN_TOL)
            ev_ms, _ = cuda_ms(lambda: kern.run_blocked(
                state, regs, steps=best.steps, m=best.m,
                block_h=best.block_h, double_buffer=best.double_buffer))
            phase(f"  {label}: {res.budget_spent} live measurements, "
                  f"{res.declined} declined, {res.skipped_illegal} without "
                  f"a legal plan; best plan host-clock wall "
                  f"{best.wall_s * 1e3:.4f} ms, CUDA events {ev_ms:.4f} ms")
            # The whole lattice, measured: the model's fidelity beyond
            # its frontier (frontier plans come from the cache).
            full = ex.search(sweep, state, regs,
                             strategy=ExhaustiveSearch(frontier_only=False),
                             calibrate=True,
                             cache=os.path.join(tmp, "b.json"))
            by_m: dict = {}
            for e in sorted(full.executed, key=lambda e: (e.m, e.block_h)):
                by_m.setdefault(e.m, []).append(
                    f"{e.block_h}: {e.measured_gflops:.0f} "
                    f"({e.rel_error:+.2f})")
            for m, cells in by_m.items():
                phase(f"  {label} lattice m {m}, block_h: measured GF/s "
                      f"(calibrated rel_error): {', '.join(cells)}")
            fb = full.best
            phase(f"  {label} lattice: {full.budget_spent} more live "
                  f"measurements; measured best (block_h {fb.block_h}, m "
                  f"{fb.m}) {fb.measured_gflops:.1f} GF/s, "
                  f"{fb.measured_mlups:.1f} MLUPS; |rel_error| max "
                  f"{max(abs(e.rel_error) for e in full.executed):.3f}")
            del out, state
            torch.cuda.empty_cache()

        # 7c. a seeded TPE study at 4096^2 and its resume.
        tex = tsim.explorer()
        tsweep = tex.sweep_gpu(bh_values=(8, 16, 32, 64),
                               m_values=(1, 2, 4, 8), d_values=(1,))
        tstate = tsim.stream_state(f0, attr)
        seqs = []
        for i in range(2):
            res = tex.search(tsweep, tstate, tsim.stream_regs(),
                             strategy=TPESearch(seed=0, max_trials=6),
                             budget=6, calibrate=False, cache=False,
                             study="phase7-tpe", study_dir=tmp)
            journal = [(r["point"]["block_h"], r["point"]["m"])
                       for r in Study.resume("phase7-tpe", tmp).records
                       if r.get("point")]
            seqs.append((res, journal))
            phase(f"  TPE study run {i + 1}: {res.budget_spent} measured, "
                  f"{res.replayed} replayed; trial sequence {journal}; "
                  f"best (block_h {res.best.block_h}, m {res.best.m}) "
                  f"{res.best.measured_gflops:.1f} GF/s")
        (r1, j1), (r2, j2) = seqs
        if r1.budget_spent != 6 or r2.budget_spent != 0:
            fail(f"TPE study: {r1.budget_spent} then {r2.budget_spent} "
                 "plans measured, expected 6 then 0")
        if j1 != j2 or r2.replayed != 6 or sorted(
                (e.block_h, e.m) for e in r2.executed) != sorted(j1):
            fail(f"TPE resume changed the trial sequence: {j1} -> {j2}")
        launches = spd_multistep_streamed.launches
        phase(f"  launches on the DSE path: "
              f"{{'spd_multistep_streamed': {launches}}}")
        if launches == 0:
            fail("the DSE path launched no stream kernel")
        del tstate, f0, attr, cases
        torch.cuda.empty_cache()

        # 7d. the FMA-chain core against its plain version.
        fma = measure.fma_chain_kernel(32)
        gen = torch.Generator(device="cuda").manual_seed(7)
        st = torch.rand((1, 4096, 4096), generator=gen, device="cuda")
        for m in (1, 4):
            bw = fma.tile(4096, 32, m)[0]
            check_equal(f"FMA-chain 4096^2 m={m} block 32x{bw} vs plain",
                        fma(st, (0.997,), m=m, block_h=32),
                        spd_multistep_plain(fma.program, st, (0.997,), m=m,
                                            block_h=32, block_w=bw))
        check_close("FMA-chain run_blocked 8 steps vs reference",
                    fma.run_blocked(st, (0.997,), steps=8, m=4, block_h=32),
                    fma.reference(st, (0.997,), m=8), RUN_TOL)
        log = build.library_path(
            f"spd_{fma.program.name}", fma.program.cuda_source()
        ).with_suffix(".log").read_text()
        for name, (regs, spill) in sorted(build.ptxas_usage(log).items()):
            phase(f"  ptxas spd_{fma.program.name} {name}: {regs} "
                  f"registers, {spill} spill bytes")
            if spill:
                fail(f"spd_{fma.program.name} {name} spills {spill} bytes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase(f"  phase 7: {time.perf_counter() - t7:.1f} s")


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py must run from a checkout holding "
              "src/repro_torch", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        sys.exit(1)

    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm
    from repro_torch.core.codegen import StripeProgram
    from repro_torch.kernels import build
    from repro_torch.core.legalize import launch_tile, tile_smem_bytes
    from repro_torch.kernels.lbm_stream.lbm_stream import (
        LBM_CELLS,
        LBM_PLANES,
        lbm_multistep,
        lbm_multistep_plain,
        lbm_owned,
    )
    from repro_torch.kernels.lbm_stream.ops import (
        lbm_run_blocked,
        lbm_run_for_point,
    )
    from repro_torch.kernels.spd_stream.sharded import (
        spd_multistep_halo,
        spd_multistep_halo_plain,
    )
    from repro_torch.kernels.spd_stream.spd_stream import (
        spd_multistep,
        spd_multistep_plain,
    )
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_halo_streamed,
        spd_multistep_streamed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60,
    ).stdout.strip().splitlines()
    card_line = smi[0] if smi else "nvidia-smi: no output"
    kind = torch.cuda.get_device_name(0)
    phase("phase 1: device")
    phase(f"  {card_line}")
    phase(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {kind}")
    dsim = dif.DiffusionSimulation(512, 1024)
    lsim = lbm.LBMSimulation(lbm.LBMProblem(512, 1024))
    dprog = dsim.kernel.program
    lkern = lsim.stream_kernel()
    lprog = lkern.program
    stream_sources = {
        "spd_Diff2D": dprog.cuda_source(),
        "spd_PEx1": lprog.cuda_source(),
        "lbm_stream": build.lbm_source(),
    }
    build_s = build.build_all({
        **stream_sources, "flash_attention": build.flash_source(),
    })
    phase(f"  built 4 kernel libraries in {build_s:.2f} s (nvcc in "
          "parallel)")
    flash_census(build)
    stream_census(build, stream_sources)
    hbm, fp32, bf16_peak = card_peaks(kind)

    # ---- 2. kernels against their plain versions at 512x1024 ----------
    phase("phase 2: kernels vs plain versions, 512x1024")
    errs = {}
    u0, _ = dif.sine_init(512, 1024)
    gen = torch.Generator(device="cpu").manual_seed(0)
    u = (u0 + 0.01 * torch.randn(512, 1024, generator=gen).cuda())
    st = dsim.state(u)
    for m in (1, 2, 4):
        plain = spd_multistep_plain(dprog, st, (0.2,), m=m, block_h=32,
                                    block_w=128)
        a = dsim.kernel(st, (0.2,), m=m, block_h=32, block_w=128)
        b = dsim.kernel.multistep(st, (0.2,), m=m, block_h=32, block_w=128)
        errs.setdefault("dif", []).append(
            check_close(f"diffusion streamed m={m}", a, plain, KERNEL_TOL))
        check_equal(f"diffusion streamed == declarative m={m}", a, b)

    def halo_pair(name, prog, state, regs, bh, bw):
        """Both halo launches on a ring shard (256 rows + two guard
        blocks, full width) and a guarded shard (the same rows, width
        512 + 2 m), against their plain version."""
        for m in (1, 4):
            for kind, width in (("ring", state.shape[2]),
                                ("guarded", 512 + 2 * m)):
                ext = state[:, :256 + 2 * bh, :width].contiguous()
                plain = spd_multistep_halo_plain(prog, ext, regs, m=m,
                                                 block_h=bh, block_w=bw)
                a = spd_multistep_halo_streamed(prog, ext, regs, m=m,
                                                block_h=bh, block_w=bw)
                a1 = spd_multistep_halo_streamed(prog, ext, regs, m=m,
                                                 block_h=bh, block_w=bw,
                                                 double_buffer=False)
                b = spd_multistep_halo(prog, ext, regs, m=m, block_h=bh,
                                       block_w=bw)
                tag = f"{name} {kind} shard m={m}"
                errs.setdefault("halo_s", []).append(check_close(
                    f"{tag} halo streamed", a, plain, KERNEL_TOL))
                errs.setdefault("halo_d", []).append(check_close(
                    f"{tag} halo declarative", b, plain, KERNEL_TOL))
                check_equal(f"{tag} halo streamed == declarative", a, b)
                check_equal(f"{tag} halo double_buffer on == off", a, a1)

    halo_pair("diffusion", dprog, st, (0.2,), 32, 128)
    cases = {}
    f, attr, _ = lbm.taylor_green_init(512, 1024)
    cases["tgv"] = (f, attr, (1 / 0.8, 0.0, 1.0), 0.0, 1 / 0.8)
    f, attr = lbm.couette_init(512, 1024)
    cases["couette"] = (f, attr, (1 / 0.9, 0.07, 1.0), 0.07, 1 / 0.9)
    for cname, (f, attr, regs, u_lid, one_tau) in cases.items():
        state = lsim.stream_state(f, attr)
        for m in (1, 4):
            plain = spd_multistep_plain(lprog, state, regs, m=m, block_h=16,
                                        block_w=32)
            a = lkern(state, regs, m=m, block_h=16, block_w=32)
            a1 = lkern(state, regs, m=m, block_h=16, block_w=32,
                       double_buffer=False)
            b = lkern.multistep(state, regs, m=m, block_h=16, block_w=32)
            c = lkern(state, regs, m=m, block_h=8, block_w=64)
            # 8x128 at m 4 holds more stripe cells than the owners: state
            # in the load slot, both launches
            fb = (lkern(state, regs, m=m, block_h=8, block_w=128),
                  lkern.multistep(state, regs, m=m, block_h=8, block_w=128))
            errs.setdefault("pe", []).append(check_close(
                f"uLBM PE {cname} m={m} streamed", a, plain, KERNEL_TOL))
            errs.setdefault("pe_decl", []).append(check_close(
                f"uLBM PE {cname} m={m} declarative", b, plain, KERNEL_TOL))
            check_equal(f"uLBM PE {cname} m={m} streamed == declarative",
                        a, b)
            check_equal(f"uLBM PE {cname} m={m} double_buffer on == off",
                        a, a1)
            check_equal(f"uLBM PE {cname} m={m} plan 16x32 == 8x64", a, c)
            if m == 4:
                if lprog.owned(8, 128, m) or not lprog.owned(16, 32, m):
                    fail("uLBM PE 8x128 / 16x32 at m 4 not on the slot / "
                         "register walks")
            check_equal(f"uLBM PE {cname} m={m} 8x128 streamed == 16x32",
                        fb[0], a)
            check_equal(f"uLBM PE {cname} m={m} 8x128 declarative == 16x32",
                        fb[1], a)
            hp = lbm_multistep_plain(f, attr, one_tau, u_lid, m=m,
                                     block_h=16, block_w=64)
            h = lbm_multistep(f, attr, one_tau, u_lid, m=m, block_h=16)
            errs.setdefault("hand", []).append(check_close(
                f"hand-written LBM {cname} m={m}", h, hp, KERNEL_TOL))
            check_close(f"generated PE vs hand-written {cname} m={m}",
                        a[:9], h, GEN_VS_HAND_TOL)
        halo_pair(f"uLBM PE {cname}", lprog, state, regs, 16, 32)
        halo_pair(f"uLBM PE {cname} 8x128 tile", lprog, state, regs, 8, 128)
        # the hand-written kernel's slot instantiation (264 x 10 cells)
        hp = lbm_multistep_plain(f, attr, one_tau, u_lid, m=4, block_h=256,
                                 block_w=2)
        h = lbm_multistep(f, attr, one_tau, u_lid, m=4, block_h=256)
        if lbm_owned(256, 2, 4):
            fail("LBM block_h 256 tile not on the slot instantiation")
        errs.setdefault("hand", []).append(check_close(
            f"hand-written LBM {cname} m=4 block_h 256 (slot)", h, hp,
            KERNEL_TOL))
        single = lkern.run_blocked(state, regs, steps=8, m=4, block_h=16)
        sk = lkern.sharded(4, devices=["cuda:0"] * 4, dx=2)
        check_equal(f"uLBM PE {cname} (2, 2) mesh on cuda:0 x4 == single "
                    "device", sk.run_blocked(state, regs, steps=8, m=4,
                                             block_h=16), single)
    for prog, kern in ((lprog, lkern), (dprog, dsim.kernel)):
        lib = prog.library()
        if lib.spd_owner_cells() != prog.owner_cells:
            fail(f"{prog.name} kernel owns {lib.spd_owner_cells()} cells, "
                 f"the legalizer prices {prog.owner_cells}")
        for db in (True, False):
            for streamed in (True, False):
                for bw in (None, 128):  # the plan's tile; 8x128: slot state
                    bw, db2 = kern.tile(1024, 8, 4, block_w=bw,
                                        double_buffer=db, streamed=streamed)
                    planes = prog.launch_planes(streamed=streamed,
                                                double_buffer=db2)
                    want = prog.smem_bytes(8, bw, 4, streamed=streamed,
                                           double_buffer=db2)
                    got = lib.spd_smem_bytes(
                        8, bw, 4, lib.spd_tile_planes(streamed, db2))
                    if got != want or lib.spd_tile_planes(
                            streamed, db2) != planes:
                        fail(f"{prog.name} shared-memory pricing {want} B "
                             f"!= kernel's {got} B")
    hlib = build.load_lbm_library()
    for bh, bw, m in ((16, 64, 4), (20, 64, 4), (16, 64, 1), (256, 2, 4),
                      (300, 1, 4)):
        want = tile_smem_bytes(bh, bw, m, halo=1, halo_x=1,
                               planes=LBM_PLANES)
        got = hlib.lbm_smem_bytes(bh, bw, m)
        if got != want:
            fail(f"LBM shared-memory pricing {want} B != kernel's {got} B")
    if hlib.lbm_max_cells() != LBM_CELLS:
        fail(f"LBM kernel owns {hlib.lbm_max_cells()} cells, the legalizer "
             f"prices {LBM_CELLS}")
    phase("  legalizer's shared-memory pricing == kernel's allocation")
    del plain, a, a1, b, c, fb, h, hp, state
    torch.cuda.empty_cache()

    # ---- 3. the main path at real size --------------------------------
    phase("phase 3: main path at real size")
    for fn in (spd_multistep_streamed, spd_multistep, lbm_multistep):
        fn.launches = 0
    StripeProgram.launches.clear()
    runs = {}

    big = dif.DiffusionSimulation(8192, 8192)
    u0, _ = dif.sine_init(8192, 8192)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = big.run(u0, steps=64, m=4)
    torch.cuda.synchronize()
    runs["dif"] = time.perf_counter() - t0
    ref = big.kernel.reference(big.state(u0), (0.2,), m=64)[0]
    check_close("diffusion 8192^2, 64 steps, m=4 vs reference", out, ref,
                RUN_TOL)
    phase(f"    {runs['dif'] * 1e3:.1f} ms for 16 launches, "
          f"{8192 * 8192 * 64 / runs['dif'] / 1e6:.0f} MLUPS")
    dif_single = out
    del ref
    torch.cuda.empty_cache()

    class Point:  # a DSE design point at the paper's m = 4
        m, detail = 4, {"block_rows": 20}

    paper = lbm.LBMSimulation(lbm.LBMProblem(300, 720, u_lid=0.05))
    pkern = paper.stream_kernel()
    f, attr = lbm.cavity_init(300, 720)
    pstate = paper.stream_state(f, attr)
    pregs = paper.stream_regs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, plan = pkern.run_for_point(pstate, pregs, point=Point(), steps=64)
    torch.cuda.synchronize()
    runs["paper"] = time.perf_counter() - t0
    ref = pkern.reference(pstate, pregs, m=64)
    check_close(f"LBM 300x720 cavity run_for_point plan {plan} vs "
                "reference", out, ref, RUN_TOL)
    paper_single = out
    phase(f"    {runs['paper'] * 1e3:.1f} ms for 16 launches, "
          f"{300 * 720 * 64 / runs['paper'] / 1e6:.0f} MLUPS")
    decl = pstate
    for _ in range(16):
        decl = pkern.multistep(decl, pregs, m=4, block_h=plan[0])
    check_equal("LBM 300x720 declarative == streamed", decl, out)
    hand, hplan = lbm_run_for_point(f, attr, paper.problem.one_tau,
                                    Point(), steps=64, u_lid=0.05)
    check_close(f"LBM 300x720 hand-written plan {hplan} vs generated",
                hand, out[:9], GEN_VS_HAND_TOL)

    f, attr, _ = lbm.taylor_green_init(4096, 4096)
    tsim = lbm.LBMSimulation(lbm.LBMProblem(4096, 4096))
    tkern = tsim.stream_kernel()
    tstate = tsim.stream_state(f, attr)
    tregs = tsim.stream_regs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tkern.run_blocked(tstate, tregs, steps=16, m=4, block_h=16)
    torch.cuda.synchronize()
    runs["tgv"] = time.perf_counter() - t0
    ref = tkern.reference(tstate, tregs, m=16)
    check_close("LBM 4096^2 TGV run_blocked m=4 vs reference", out, ref,
                RUN_TOL)
    tgv_single = out
    phase(f"    {runs['tgv'] * 1e3:.1f} ms for 4 launches, "
          f"{4096 * 4096 * 16 / runs['tgv'] / 1e6:.0f} MLUPS")
    hand = lbm_run_blocked(f, attr, tsim.problem.one_tau, steps=16, m=4,
                           block_h=16)
    check_close("LBM 4096^2 hand-written vs generated", hand, out[:9],
                GEN_VS_HAND_TOL)

    # after the timed runs: its plain version's 720 tiles fill the
    # allocator's cache
    class TallPoint:  # a tile taller than the LBM kernel's owners hold
        m, detail = 4, {"block_rows": 300}

    f, attr = lbm.cavity_init(300, 720)
    tall, tplan = lbm_run_for_point(f, attr, paper.problem.one_tau,
                                    TallPoint(), steps=8, u_lid=0.05)
    twant = f
    tbw = launch_tile(720, 300, 4, halo=1, halo_x=1,
                      planes=lambda db: LBM_PLANES, double_buffer=False)[0]
    for _ in range(2):
        twant = lbm_multistep_plain(twant, attr, paper.problem.one_tau, 0.05,
                                    m=4, block_h=300, block_w=tbw)
    if tplan != (300, 4) or lbm_owned(300, tbw, 4):
        fail(f"LBM 300x720 block_rows 300: plan {tplan}, tile 300x{tbw}")
    check_equal(f"LBM 300x720 cavity lbm_run_for_point block_rows 300 plan "
                f"{tplan} (tile 300x{tbw}, slot instantiation) == plain",
                tall, twant)
    del tall, twant

    body = dict(StripeProgram.launches)
    launches = {
        "spd_multistep_streamed[Diff2D]": body.get("Diff2D", 0),
        "spd_multistep_streamed[PEx1]":
            spd_multistep_streamed.launches - body.get("Diff2D", 0),
        "spd_multistep[PEx1]": spd_multistep.launches,
        "stripe_body": sum(body.values()),
        "lbm_multistep": lbm_multistep.launches,
    }
    phase(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the main path")
    del out, ref, hand, decl
    torch.cuda.empty_cache()

    # ---- 3b. spatial parallelism on one card --------------------------
    phase("phase 3b: spatial parallelism on one card (device list "
          "['cuda:0'] * d)")
    for fn in (spd_multistep_halo_streamed, spd_multistep_halo,
               spd_multistep_streamed, spd_multistep):
        fn.launches = 0
    StripeProgram.launches.clear()
    mesh = {}

    def exchange_ms(sk, state, m, block_h):
        """CUDA-event ms of one exchange of the run's shards, alone."""
        sb = sk.shards(state, m=m, block_h=block_h)
        ms, _ = cuda_ms(lambda: (sb.exchange_x(), sb.exchange_y()), 20)
        return ms, sb.exchange_bytes()

    def mesh_run(name, kern, state, regs, dy, dx, want, steps, m, block_h,
                 single_s, **kw):
        sk = kern.sharded(dy * dx, devices=["cuda:0"] * (dy * dx), dx=dx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if "point" in kw:
            out, plan = sk.run_for_point(state, regs, steps=steps, **kw)
            block_h, m = plan[0], plan[1]
            name = f"{name} plan {plan}"
        else:
            out = sk.run_blocked(state, regs, steps=steps, m=m,
                                 block_h=block_h, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_equal(f"{name} == single device", out, want)
        ex, nbytes = exchange_ms(sk, state, m, block_h)
        cells = state.shape[1] * state.shape[2]
        share = ex * (steps // m) / (wall * 1e3)
        mesh[name] = dict(wall_ms=wall * 1e3,
                          mlups=cells * steps / wall / 1e6,
                          single_mlups=cells * steps / single_s / 1e6,
                          exchange_ms=ex, exchange_bytes=nbytes,
                          exchange_share=share)
        phase(f"    {wall * 1e3:.1f} ms, {mesh[name]['mlups']:.0f} MLUPS "
              f"(single device {mesh[name]['single_mlups']:.0f}); "
              f"exchange alone {ex:.4f} ms x {steps // m} launches = "
              f"{share:.1%} of the wall, {nbytes} B each")
        torch.cuda.empty_cache()

    dstate = big.state(u0)
    for dy, dx in ((4, 1), (2, 2)):
        for overlap in (True, False):
            mesh_run(
                f"diffusion 8192^2 ({dy}, {dx}) overlap={overlap}",
                big.kernel, dstate, (0.2,), dy, dx, dif_single[None], 64,
                4, 32, runs["dif"], overlap=overlap)
    ring = big.kernel.sharded(4, devices=["cuda:0"] * 4)
    decl = dstate
    for _ in range(16):
        decl = ring.multistep(decl, (0.2,), m=4, block_h=32)
    check_equal("diffusion 8192^2 (4, 1) declarative halo twin == single "
                "device", decl, dif_single[None])
    del decl
    n_dif = spd_multistep_halo_streamed.launches
    mesh_run("uLBM PE 4096^2 TGV (2, 2)", tkern, tstate, tregs, 2, 2,
             tgv_single, 16, 4, 16, runs["tgv"])
    mesh_run("LBM 300x720 cavity run_for_point (2, 2)", pkern, pstate,
             pregs, 2, 2, paper_single, 64, None, None, runs["paper"],
             point=Point())
    body = dict(StripeProgram.launches)
    launches_mesh = {
        "spd_multistep_halo_streamed[Diff2D]": n_dif,
        "spd_multistep_halo_streamed[PEx1]":
            spd_multistep_halo_streamed.launches - n_dif,
        "spd_multistep_halo[Diff2D]": spd_multistep_halo.launches,
        "stripe_body": sum(body.values()),
    }
    phase(f"  launches on the mesh path: {launches_mesh}")
    for name, n in launches_mesh.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the mesh path")
    del dif_single, tgv_single
    torch.cuda.empty_cache()

    # ---- 4. physics through the kernels -------------------------------
    phase("phase 4: physics")
    tau = 0.8
    f, attr, ksq = lbm.taylor_green_init(64, 64, u0=0.02)
    psim = lbm.LBMSimulation(lbm.LBMProblem(64, 64, tau=tau))
    e0 = lbm.tgv_kinetic_energy(f)
    g = psim.stream_kernel().run_blocked(psim.stream_state(f, attr),
                                         psim.stream_regs(), steps=200, m=4,
                                         block_h=16)
    e1 = lbm.tgv_kinetic_energy(g[:9])
    want = e0 * math.exp(-2.0 * lbm.viscosity(tau) * ksq * 200)
    if not abs(e1 - want) <= 0.02 * want:
        fail(f"TGV energy {e1} vs analytic {want}")
    phase(f"  TGV 64x64, 200 steps: energy {e1:.6e} vs analytic "
          f"{want:.6e} (rel {abs(e1 - want) / want:.2e} <= 0.02)")
    sim = dif.DiffusionSimulation(32, 128, alpha=0.2)
    u0, decay = dif.sine_init(32, 128)
    uu = sim.run(u0, 40, m=4, block_h=8)
    ratio = float(torch.linalg.norm(uu) / torch.linalg.norm(u0))
    want = decay(0.2) ** 40
    if not abs(ratio - want) <= 1e-4 * want:
        fail(f"diffusion decay {ratio} vs exact {want}")
    phase(f"  diffusion sine 32x128, 40 steps: ratio {ratio:.7f} vs exact "
          f"{want:.7f} (rel {abs(ratio - want) / want:.2e} <= 1e-4)")

    # ---- 6. LM serving (before phase 5, which times its kernel) ------
    from repro_torch.configs import get_arch

    lm = lm_serving(get_arch("qwen3-8b"))

    # ---- 5. timing at the main-path shapes ----------------------------
    phase("phase 5: timing (CUDA events) and kernel vs plain at the "
          "main-path shapes")
    kernels = []

    def record(name, source, replaces, n, ms, plain_ms, nbytes, ops,
               err, library_ms=None, peak=fp32):
        t_bytes, t_ops = nbytes / hbm * 1e3, ops / peak * 1e3
        bound = max(t_bytes, t_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
        phase(f"  {name}: {ms:.4f} ms/launch, bound {bound:.4f} ms "
              f"({kernels[-1]['bound_by']}, {bound / ms:.1%} of it), "
              f"plain {plain_ms:.2f} ms"
              + (f", library {library_ms:.4f} ms" if library_ms else ""))

    # Diffusion 8192^2, m 4, block 32x128: the run's launch.
    st = big.state(dif.sine_init(8192, 8192)[0])
    buf = torch.empty_like(st)
    bw, db = big.kernel.tile(8192, 32, 4)
    ms, plain_ms, err = timed_pair(
        "diffusion 8192^2 m=4",
        lambda: spd_multistep_streamed(dprog, st, (0.2,), m=4, block_h=32,
                                       block_w=bw, double_buffer=db,
                                       out=buf),
        lambda: spd_multistep_plain(dprog, st, (0.2,), m=4, block_h=32,
                                    block_w=bw))
    import torch.nn.functional as F

    a = 0.2
    w5 = torch.tensor([[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]],
                      dtype=torch.float32, device="cuda").view(1, 1, 3, 3)

    def conv_steps():
        x = st[None]
        for _ in range(4):
            x = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="circular"), w5)
        return x

    lib_ms, _ = cuda_ms(conv_steps)
    flops = big.hardware_report.flops
    record("spd_multistep_streamed[Diff2D]",
           "src/repro_torch/csrc/spd_stream.cuh",
           "src/repro/kernels/spd_stream/streaming.py:180",
           launches["spd_multistep_streamed[Diff2D]"], ms, plain_ms,
           2 * 8192 * 8192 * 4, flops * 4 * 8192 * 8192,
           max(errs["dif"] + [err]), lib_ms)
    del st, buf
    torch.cuda.empty_cache()

    # uLBM PE 4096^2, m 4, block 16: the run_blocked launch.
    buf = torch.empty_like(tstate)
    bw, db = tkern.tile(4096, 16, 4)
    ms, plain_ms, err = timed_pair(
        "uLBM PE 4096^2 m=4",
        lambda: spd_multistep_streamed(lprog, tstate, tregs, m=4,
                                       block_h=16, block_w=bw,
                                       double_buffer=db, out=buf),
        lambda: spd_multistep_plain(lprog, tstate, tregs, m=4, block_h=16,
                                    block_w=bw), plain_iters=1)
    pe_flops = tsim.hardware_report.flops
    record("spd_multistep_streamed[PEx1]",
           "src/repro_torch/csrc/spd_stream.cuh",
           "src/repro/kernels/spd_stream/streaming.py:180",
           launches["spd_multistep_streamed[PEx1]"], ms, plain_ms,
           2 * 10 * 4096 * 4096 * 4, pe_flops * 4 * 4096 * 4096,
           max(errs["pe"] + [err]))
    del buf
    torch.cuda.empty_cache()

    # The paper's 300x720 grid, m 4: declarative and streamed launches
    # (the stripe body's time is that of the launch it runs in).
    bh = plan[0]
    pbuf = torch.empty_like(pstate)
    bwd = pkern.tile(720, bh, 4, double_buffer=False, streamed=False)[0]
    ms_d, plain_d, err_d = timed_pair(
        "uLBM PE 300x720 m=4 declarative",
        lambda: spd_multistep(lprog, pstate, pregs, m=4, block_h=bh,
                              block_w=bwd, out=pbuf),
        lambda: spd_multistep_plain(lprog, pstate, pregs, m=4, block_h=bh,
                                    block_w=bwd), iters=50)
    nb, ops = 2 * 10 * 300 * 720 * 4, pe_flops * 4 * 300 * 720
    record("spd_multistep[PEx1]", "src/repro_torch/csrc/spd_stream.cuh",
           "src/repro/kernels/spd_stream/spd_stream.py:65",
           launches["spd_multistep[PEx1]"], ms_d, plain_d, nb, ops,
           max(errs["pe_decl"] + [err_d]))
    bws, dbs = pkern.tile(720, bh, 4)
    ms_s, plain_s, err_s = timed_pair(
        "uLBM PE 300x720 m=4 streamed",
        lambda: spd_multistep_streamed(lprog, pstate, pregs, m=4,
                                       block_h=bh, block_w=bws,
                                       double_buffer=dbs, out=pbuf),
        lambda: spd_multistep_plain(lprog, pstate, pregs, m=4, block_h=bh,
                                    block_w=bws), iters=50)
    record("stripe_body[PEx1]", "src/repro_torch/core/codegen.py",
           "src/repro/core/codegen.py:461",
           launches["stripe_body"], ms_s, plain_s, nb, ops,
           max(errs["pe"] + errs["pe_decl"] + errs["dif"] + [err_s]))

    # The halo kernels at one shard of the phase-3b runs: each launch
    # reads local_h + 2 m halo rows and writes local_h rows.
    def halo_bytes(p, local_h, mh, w):
        return 4 * p * ((local_h + 2 * mh) + local_h) * w

    sk = tkern.sharded(4, devices=["cuda:0"] * 4, dx=2)
    sb = sk.shards(tstate, m=4, block_h=16)
    sb.exchange_x()
    sb.exchange_y()
    ext = sb.src(0, 0)
    wl = ext.shape[2]
    hbuf = torch.empty((10, 2048, wl), device="cuda")
    bw, db = tkern.tile(wl, 16, 4)
    ms, plain_ms, err = timed_pair(
        f"uLBM PE (2, 2) shard 2048x{wl} m=4 streamed halo",
        lambda: spd_multistep_halo_streamed(lprog, ext, tregs, m=4,
                                            block_h=16, block_w=bw,
                                            double_buffer=db, out=hbuf),
        lambda: spd_multistep_halo_plain(lprog, ext, tregs, m=4, block_h=16,
                                         block_w=bw), plain_iters=1)
    record("spd_multistep_halo_streamed[PEx1]",
           "src/repro_torch/csrc/spd_stream.cuh",
           "src/repro/kernels/spd_stream/streaming.py:216",
           launches_mesh["spd_multistep_halo_streamed[PEx1]"], ms, plain_ms,
           halo_bytes(10, 2048, 4, wl), pe_flops * 4 * 2048 * wl,
           max(errs["halo_s"] + [err]))
    del sk, sb, ext, hbuf
    torch.cuda.empty_cache()
    sk = big.kernel.sharded(4, devices=["cuda:0"] * 4)
    sb = sk.shards(dstate, m=4, block_h=32)
    sb.exchange_y()
    ext = sb.src(0, 0)
    hbuf = torch.empty((1, 2048, 8192), device="cuda")
    bw = big.kernel.tile(8192, 32, 4, double_buffer=False,
                         streamed=False)[0]
    ms, plain_ms, err = timed_pair(
        "diffusion (4, 1) shard 2048x8192 m=4 declarative halo",
        lambda: spd_multistep_halo(dprog, ext, (0.2,), m=4, block_h=32,
                                   block_w=bw, out=hbuf),
        lambda: spd_multistep_halo_plain(dprog, ext, (0.2,), m=4,
                                         block_h=32, block_w=bw))
    record("spd_multistep_halo[Diff2D]",
           "src/repro_torch/csrc/spd_stream.cuh",
           "src/repro/kernels/spd_stream/sharded.py:46",
           launches_mesh["spd_multistep_halo[Diff2D]"], ms, plain_ms,
           halo_bytes(1, 2048, 4, 8192), flops * 4 * 2048 * 8192,
           max(errs["halo_d"] + [err]))
    del sk, sb, ext, hbuf, dstate
    torch.cuda.empty_cache()

    # Hand-written LBM 4096^2, m 4, block 16.
    f4 = tstate[:9].contiguous()
    attr4 = tstate[9].contiguous()
    fbuf = torch.empty_like(f4)
    bwh = launch_tile(4096, 16, 4, halo=1, halo_x=1,
                      planes=lambda db: LBM_PLANES, double_buffer=False)[0]
    ms, plain_ms, err = timed_pair(
        "hand-written LBM 4096^2 m=4",
        lambda: lbm_multistep(f4, attr4, 1 / 0.8, 0.0, m=4, block_h=16,
                              block_w=bwh, out=fbuf),
        lambda: lbm_multistep_plain(f4, attr4, 1 / 0.8, 0.0, m=4,
                                    block_h=16, block_w=bwh), plain_iters=1)
    record("lbm_multistep", "src/repro_torch/csrc/lbm_stream.cu",
           "src/repro/kernels/lbm_stream/lbm_stream.py:119",
           launches["lbm_multistep"], ms, plain_ms,
           19 * 4096 * 4096 * 4, 131 * 4 * 4096 * 4096,
           max(errs["hand"] + [err]))

    # Flash attention at the Qwen3-8B prefill's launch shape (bf16, causal).
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    # Two layouts: contiguous (B, H, S, D), and the head-split views of
    # (B, S, H, D) buffers that the prefill passes (read in place).
    q, k, v = lm["qkv"]
    b_, hq_, s_, d_ = q.shape
    ops = 4 * b_ * hq_ * d_ * (s_ * (s_ + 1) // 2)  # causal, sq == sk
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms = max(ops / bf16_peak, nbytes / hbm) * 1e3
    plain_ms, want = cuda_ms(lambda: flash_attention_plain(q, k, v), 2)
    views = tuple(x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    flash_errs = []
    for layout, (qq, kk, vv) in (("contiguous", (q, k, v)),
                                 ("head-split views", views)):
        ms, got = cuda_ms(lambda: flash_attention(qq, kk, vv), 20)
        flash_errs.append(check_close(
            f"flash prefill shape, {layout}, vs plain", got.float(),
            want.float(), FLASH_TOL["bfloat16"]))
        lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True), 20)
        phase(f"  flash {layout}: {ms:.4f} ms, {ops / ms / 1e9:.1f} "
              f"TFLOP/s, {bound_ms / ms:.1%} of the bound "
              f"({bound_ms:.4f} ms); SDPA {lib_ms:.4f} ms "
              f"({ops / lib_ms / 1e9:.1f} TFLOP/s)")
    # The row holds the layout of the main path: the head-split views.
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/flash_attention.py:106",
           lm["launches"], ms, plain_ms, nbytes, ops,
           max(lm["errs"] + flash_errs), lib_ms, peak=bf16_peak)

    del q, k, v, views, want, got, lm
    torch.cuda.empty_cache()

    # The stencil kernels' design choices side by side, on the same
    # main-path inputs (three rounds after a warm-up).
    from repro_torch.kernels.lbm_stream import variants as lbm_variants
    from repro_torch.kernels.spd_stream import variants as spd_variants

    phase("  design variants (CUDA events, 3 rounds after a warm-up):")
    for name, r in lbm_variants.run(f4, attr4, 1 / 0.8).items():
        phase(f"  lbm {name} ({r['block_h']}x{r['block_w']}): "
              f"{sum(r['ms']) / len(r['ms']):.4f} ms "
              f"({', '.join(f'{t:.4f}' for t in r['ms'])}); "
              f"{r['regs']} registers, {r['spill']} spill bytes; max abs "
              f"err vs plain {r['max_abs_err']:.3e}")
        if r["max_abs_err"] > 0:
            fail(f"LBM variant {name} differs from the plain version")
    phase(f"  lbm library lookup per launch, host ms: "
          f"{lbm_variants.library_lookup_ms()}")
    del f4, attr4, fbuf
    variant_runs = (
        ("uLBM PE 4096^2 m 4", lprog, tstate, tregs, 16),
        ("diffusion 8192^2 m 4", dprog,
         big.state(dif.sine_init(8192, 8192)[0]), (0.2,), 32),
    )
    for label, prog, state, regs, bh in variant_runs:
        res = spd_variants.run(prog, state, regs, m=4, block_h=bh)
        for line in spd_variants.report(label, res):
            phase(line)
        if not all(r["bitwise"] for r in res.values()):
            fail(f"{label}: a variant differs from the shipped launch")
    del variant_runs, state
    torch.cuda.empty_cache()

    phase(f"  mesh runs: {json.dumps(mesh)}")
    dse_loop(kind, hbm, fp32)
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
