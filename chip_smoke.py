#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it imports nothing of JAX or of the ``repro``
package. Phases, each printed as it ends; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, the parallel ``nvcc`` build of every kernel, the
   flash library's ptxas registers and spills (the four Hopper
   instantiations, (D, Dv) (64, 64), (112, 112), (128, 128) and (192,
   128), and the backward's, must spill nothing) and SASS
   census (wgmma, TMA and mbarrier instructions), and the registers and
   spills of every kernel of the two stream libraries (generated SPD,
   hand-written LBM);
2. each kernel against its plain torch version on the card at 512×1024,
   plus the bitwise invariances (streamed == declarative, double_buffer on
   == off, two tilings agree), the generated uLBM PE against the
   hand-written LBM kernel, both halo launches on a ring shard and on a
   width-extended shard, and a (2, 2) mesh on ``["cuda:0"] * 4`` against
   the single-device run;
2b. the batch axis (docs/port.md §serve): both periodic launches over
   ``(B, P, H, W)`` batches, B 1, 3 and 8 of diffusion 2048² (m 4, block
   32) and of the uLBM PE on the 300×720 cavity (m 4, block 20), B 13 of
   the uLBM PE at 4096² (past 2^31 floats): every member bitwise equal to
   its own launch, B 3 and 8 to the plain version, each launch timed
   (CUDA events) against its bound, diffusion beside ``conv2d`` with
   N = B;
3. the main path at real size, with every launch count set to 0 just
   before and read just after: diffusion 8192² (64 steps, m 4), the
   paper's 300×720 LBM grid through ``run_for_point`` at m 4 (and its
   declarative and hand-written twins), LBM 4096² through ``run_blocked``
   (and the hand-written kernel); each run is held to
   ``StreamKernel.reference`` on the card;
3b. spatial parallelism on one card, counts set to 0 again: the same
   inputs through ``ShardedStreamKernel`` on a device list that repeats
   ``cuda:0`` — diffusion 8192² on a (4, 1) ring and a (2, 2) mesh (and
   the declarative twin), uLBM 4096² on a (2, 2) mesh, the
   300×720 cavity through ``run_for_point`` on a (2, 2) mesh — each
   bitwise equal to its single-device run of phase 3, with its wall time,
   MLUPS and the exchange's time apart from the launches;
4. physics through the kernels: Taylor-Green decay and the diffusion sine
   mode;
6. LM serving (run before phase 5): (a) the flash-attention kernel
   against its plain version on the reference's test matrix at D 128 in
   f32 and bf16, two block shapes (bitwise equal), and the Qwen3-8B
   prefill shape; (b) Qwen3-8B at full width in bf16 (random weights from
   a seeded generator): the prefill step on 4 prompts of 2048 tokens,
   flash launches counted from 0, the logits at every position held to
   the same model with plain attention beside its rounding floor; (c)
   the continuous-batching engine at full width, 8 requests on 4 slots;
   (d) greedy consistency at full width and 4 layers in f32: two slots
   at one position and a third request in a re-used slot, engine tokens
   == argmax of the kernel-run forward, and decode logits == forward
   logits;
6p. the pipelined prefill (docs/port.md §parallel), on phase 6's model:
   Qwen3-8B's 36 layers in 4 stages of a stage mesh over ``["cuda:0"] *
   4``, 4 microbatches of 1x2048 through ``pipelined_forward``: bitwise
   the layers run on each microbatch in turn, 144 flash launches (none on
   an idle tick), the wall beside the sequential one and the 4x2048
   prefill's, the hand-off bytes per tick; the kernel at the B 1 launch
   shape against its plain version;
6h. hybrid LM serving (docs/port.md §hybrid), phase 6's four steps on
   Zamba2-7B: (a) at D 112 (the Hopper kernel's padded instantiation in
   bf16, the simple kernel in f32) and the shared block's prefill shape q
   = kv = (4, 32, 2048, 112); (b) the prefill at full width and depth (81
   Mamba2 layers, 6.75 B parameters, bf16), 13 flash launches (one per
   site of the shared block), logits held to the plain-attention twin;
   (c) the engine at full width; (d) 8 layers in f32 (one group and two
   tail layers); (e) the 4x2048 prefill at full depth in f32 (25 GiB of
   weights; the simple kernel's f32 instantiation at D 112) against plain
   attention, the logits within ``ENC_DEC_REL_L2`` (no rounding floor);
6m. MoE serving (docs/port.md §moe), Mixtral-8x7B at full width and 16
   of its 32 layers, bf16: (a) the kernel at both prefills' launch shapes
   with the window of 4096; (b) the prefills 4x2048 and 1x8192 (where
   the window binds), 16 flash launches each, every site held to its
   plain version on its own q, k, v, the logits at every position and
   past the window to the plain-attention twin, the tokens whose top-k
   experts differ from the twin's counted; (c) the engine; (d) 2 layers
   in f32 at the no-drop capacity factor E/k;
6e. the expert-parallel prefill, on phase 6m's model: the 4x2048 prefill
   under ``ep="model", ep_size=4, dp=("data",), dp_size=2, a2a=mesh`` on
   a (data 2, model 4) mesh over ``["cuda:0"] * 8``, every MoE layer's
   experts behind two all-to-alls (``moe_ep_apply``), against the
   two-stage dispatch at ``dp_size`` 8: the first MoE layer's drops per
   rank equal to its drops per block, the logits by 6m's floor rule, 16
   flash launches, the all-to-all bytes a layer against ``tokens_loc ·
   top_k · d · 2 B``; then 2 layers in f32 at E/k within
   ``EP_F32_REL_L2``;
6k. Kimi K2 at full width and 2 layers (the dense first layer, one MoE
   layer of 384 experts and the shared expert), bf16: (a) and (b) of 6m
   at its 4x2048 prefill, D 112 with GQA 64:8, 2 flash launches;
6w. encoder-decoder serving (docs/port.md §encdec), whisper-medium at
   full width and depth (24 + 24 layers, D 64), 8 clips of 1500 frames
   and 375 tokens, ragged against the kernel's tiles: (a) the reference's
   matrix at D 64 and the path's four launch shapes through the
   dispatcher (encoder and cross-attention non-causal, Sq 375 against
   Sk 1500, the decoder causal, the decode step's cross-attention at
   Sq 1); (b) ``forward_enc_dec`` in bf16, 72 flash launches (24 of each
   prefill shape), each site held to its plain version, the logits to
   the plain-attention twin by the floor rule; (d) ``encode``,
   ``prime_cross_cache`` and a decode step timed (24 launches a step);
   then in f32 at full depth the logits against the twin within
   ``ENC_DEC_REL_L2`` and (c) 32 teacher-forced decode steps against the
   forward's rows, argmax equal at every position;
6v. the VLM (docs/port.md §vlm), LLaVA-NeXT-34B at full width and the
   deepest depth of its 60 layers that fits (printed), bf16: (a) and (b)
   of 6m at its 1x4096 prefill (2,880 seeded frontend embeds and 1,216
   tokens from ``make_batch``), D 128 with GQA 56:8; (c) the engine on
   text prompts; (d) 4 layers in f32;
6d. the dense configs beside Qwen3-8B (docs/port.md §dense-card),
   granite-34b (MQA 48:1, GELU), nemotron-4-15b (GQA 48:8, squared ReLU,
   256,000 tokens) and qwen2.5-32b (GQA 40:8, qkv biases), each at full
   width in bf16 and the deepest depth that fits beside
   ``DENSE_HEADROOM`` and its logits (all of each, printed): phase 6's
   (a)-(c) at the 4x2048 prefill (groups 48, 6 and 5 at D 128) and (d) at
   2 layers in f32; each model freed before the next;
6x. SSM serving (docs/port.md §ssm), xLSTM-125m at full width and depth
   (12 blocks, sLSTM at 5 and 11), bf16: (a) the prefill 4x2048 (chunk
   128) with its device activities per prefill (the sLSTM blocks' Python
   loop over 2048 positions makes it host-bound), and one block of each
   kind alone; (b) the engine, 8 requests on 4 slots, and one decode step
   beside its host enqueue; (c) in f32 at full depth over 256 tokens, each
   block's chunked apply against its step-by-step decode (the reference's
   rtol 2e-3 / atol 2e-4 for that pair) and the whole model's decode
   against the chunked forward (argmax equal, ``SSM_REL_L2``); (d) f32
   engines at 6 blocks,
   ``max_batch`` 2 and 3, against the greedy forward;
11. training (docs/port.md §train), run before phase 5: (a) xLSTM-125m at
   full width and depth through the port's loop, bf16 weights and f32
   AdamW, 8x2048 synthetic tokens a step, 12 steps with a checkpoint every
   4 and faults after steps 6 and 9, beside the same 12 steps unbroken:
   two restarts, every loss finite, the losses after the last restore
   within ``TRAIN_LOSS_RTOL`` of the unbroken run's, the newest
   checkpoint restored bitwise, with step ms, tokens/s, peak memory and
   the seconds of a save and a restore; (b) Qwen3-8B at full width and 8
   of its 36 layers, B 2 x 2048: step 0's gradients through the kernel
   (8 launches forward and 8 in the backward, which recomputes each
   layer under the default remat ``"none"``, and 8 of the backward
   kernel) against plain attention's,
   every leaf within the larger of ``GRAD_REL_L2`` and 1.5x its rounding
   floor, then 3 steps of ``make_train_step`` and ``REMAT_STEPS`` more
   under each of the remat policies ``"sublayers"`` and ``"off"`` (step
   ms, peak memory, launches, the backward kernel's a step), and at the
   training shape the kernel's forward, the backward kernel (alone and
   through ``FlashAttentionFn``, against its five-product bound, two
   launches bitwise equal, its gradients held to the plain recompute's),
   the plain recompute it replaced and ``scaled_dot_product_attention``
   forward + backward; (c) xLSTM-125m's
   8x2048 batch over 2 data ranks of ``["cuda:0"] * 2``, each rank's
   gradients and ``compressed_psum``: ``none`` bitwise the f32 mean of
   ``make_train_step(num_microbatches=2)``, int8 within its bound, top-k
   ``deq + residual == x``, the payloads; (d) the other families
   (``TRAIN_FAMILIES``: Mixtral-8x7B at 2 layers, Zamba2-7B at 12 with its
   two shared-block sites, whisper-medium whole at 8 clips of 1500 frames
   and 375 tokens, LLaVA-NeXT-34B at 4 with 2,880 embeds and 1,216
   tokens), bf16 parameters and f32 moments: (b)'s gradient gate with the
   flash launches forward and backward (remat ``"none"``), the floor's
   noise keyed to each output so that the recompute moves it alike,
   Mixtral's experts held to the kernel run's; 3 steps of
   ``make_train_step`` (losses, step ms, tokens/s, peak memory, launches
   by shape, and the fused AdamW pass's launches of each step, its
   counters set to 0 first: one norm launch a table of parts, the
   finalize and one update launch a table); each launch shape of the
   steps against its plain version;
   (e) the fused AdamW pass (``csrc/adamw.cu``) at the train cell's 23
   parts (Mixtral-8x7B at 2 layers, 3.16 B parameters): its registers and
   spills, the norm within 1e-5 of ``_global_norm``, the kernel pair, the
   plain pass and ``torch._fused_adamw_`` (on f32 copies of p and g: it
   takes one dtype) timed (CUDA events) beside the bound (each state word
   read and written once), the pair at most 1.35x it; then one launch over
   the 23-part table bitwise ``_update``'s on every part; (f) Kimi K2's
   multi-head latent attention (docs/port.md §mla): ``kimi-k2-instruct``
   at full width and the benchmark cell's cut (``MLA_TRAIN_LAYERS``: the
   dense layer and 4 expert layers, 8 of 384 experts held, a vocabulary
   of 20,480) through ``make_train_step`` at the cell's 2x8192 tokens,
   ``DENSE_STEPS`` steps with the (192, 128) launch counters set to 0
   just before: 2 forward launches (the forward and the remat recompute)
   and 1 backward call a layer, no flash launch at another pair, and
   ``mla.calls`` 2 a layer; then at the cell's launch shape (q = k
   2x64x8192x192, v 2x64x8192x128) the forward's output against
   ``flash_attention_plain`` and its LSE, dq, dk and dv against
   ``attention_lse_ref`` and ``flash_attention_bwd_plain`` over every
   head, two heads at a time, at the card tests' tolerances, two
   launches of each bitwise equal, the backward timed against its
   five-product bound beside its plain version and SDPA forward +
   backward;
12. the dry run against the card (docs/port.md §dryrun), after phase 11:
   ``launch/dryrun.py`` traces a step on the ``meta`` device; (a) Qwen3-8B's
   4x2048 prefill on a 1x1 mesh: its argument bytes within ``ARGS_RTOL``
   of what the card allocates for the model and the batch, its flops
   equal to the ``CostMode`` count of the same prefill run on the card
   with plain attention, its peak temporaries beside the card's, and
   phase 6's kernel prefill in TFLOP/s by that count and against the HBM
   proxy; (b) the same for phase 11b's training step (8 layers, 2x2048,
   the AdamW moments in the arguments, the remat recompute in the
   flops); (c) ``run_cell`` on ``DRYRUN_CELLS`` on the 16x16 production
   mesh, each cell's per-rank bytes beside the card's memory;
5. at the main-path shapes, each kernel held to its plain version again
   and timed (CUDA events) against its bound, its plain version and, for
   diffusion and flash attention, one PyTorch call (``library_ms``); the
   halo kernels at one shard of the phase-3b runs; flash attention at
   the LM phases' launch shapes (D 128 causal, D 112 MHA, Mixtral's D 128
   at 1x8192 with the window binding, Kimi's D 112 with GQA 8,
   whisper's four at D 64, LLaVA's D 128 with GQA 7, the Qwen3-8B
   training step's D 128 with GQA 4 at B 2, phase 6d's groups 48, 6 and
   5, phase 11d's training launch shapes and phase 11f's MLA training
   shape at D 192 and Dv 128), through the
   dispatcher, on contiguous q/k/v and on the head-split views, with TFLOP/s,
   the share of its bound (the (query, key) pairs the mask keeps) and
   ``scaled_dot_product_attention`` (the window as a boolean mask, on the
   fastest backend that takes it, named);
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
   ``StreamKernel.reference``, then the whole lattice measured and the
   model's pick printed beside its best, with their ratio; (c) a seeded TPE study (budget 6) at
   4096² and its resume, which measures nothing and keeps the trial
   sequence; (d) the FMA-chain kernel against its plain version, bitwise;
8. stream programs on the card (docs/port.md §program), stream launch
   counts set to 0 just before (a) and read just after (b), the main
   path's counts in the ``kernels`` line, and set to 0 again before and
   printed after each of (c), (d) and (e): (a) the 3-core uLBM
   program at 4096² (TGV), partitions "3", "2+1", "1+2" and "1+1+1" at
   block 16, m 4, 8 steps, each bitwise equal to the PE's
   ``run_blocked`` at the same plan, with ms per step (CUDA events),
   launches per step and the bound per step; (b) advection-diffusion at
   8192² (blob), "2" and "1+1" at block 32, m 4, each bitwise equal to
   the monolithic AdvDiff2D kernel and within atol 1e-5 of the torch
   oracle; (c) a pipelined run under ``set_sync_debug_mode("error")``
   and ``run_unfused`` at 1024² beside it; (d) one partition of each app
   on a (2, 2) mesh over ``["cuda:0"] * 4``, bitwise equal to one device;
   (e) ``python -m repro_torch.cli explore --program --strategy halving
   --budget 12`` in-process, twice (the repeat measures nothing); (f)
   every cluster core timed against its bound and held to its plain
   version (the rows of the ``kernels`` line). Phase 1 builds and
   censuses the nine cluster libraries with the other kernels; any spill
   fails there;
9. simulation serving on the card (docs/port.md §serve), launch counts
   set to 0 just before and read just after each run below: one
   ``SimEngine`` with three contexts (uLBM PE 300×720 cavity, diffusion
   2048² at α 0.2 and 0.1), 8 requests of 64 steps each, Poisson
   arrivals at 8 per tick, autotune on the first request (budget 4, b ∈
   {1, 2, 4, 8}): its counts (tuning timings and serving), MLUPS end to
   end and over the launches' wall, latency percentiles, batch occupancy
   (a width above 1), live timings and pinned plans; a second engine on
   the same studies, whose ``serve_traffic`` is the serving path: 0 live
   timings and as many kernel launches as engine launches; one tick
   under ``set_sync_debug_mode("error")``; ``python -m repro_torch.cli
   serve`` in-process, warm; the declarative twin, off the serving path
   (one full cohort of each context through ``spd_multistep``); every
   completion and twin member bitwise equal to its own ``run_blocked``
   on the CPU (the plain version) at the pinned plan; and both launches
   timed on a full cohort (b members) at the pinned plans, against the
   plain version and, for diffusion, ``conv2d`` with N = b — the kernels
   line's batched rows, with the serving path's and the twin's counts;
10. the paper's flow (docs/port.md §examples): the port's three examples
   on the card — ``examples/torch_quickstart.py`` against numpy f32,
   ``torch_dse_explore.py --topk 1``, and ``torch_lbm_simulation.py`` on
   a 2048² cavity (m 4, 400 steps, a checkpoint every 100) in a temporary
   directory, then again from scratch to 200 steps and to 400, restoring
   at 200: the final ``f`` bitwise equal to the unbroken run's, a saved
   checkpoint restored bitwise, with MLUPS and the seconds per save and
   for the restore.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

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


def _row_chunks(a, b, elems: int = 2**26):
    """``a`` and ``b`` as f64 pieces of at most ``elems`` elements (whole
    rows of their last dimension, at least one), so that a comparison of
    two logits tensors never holds a whole f64 copy: 0.5 GiB a piece,
    whatever the vocabulary."""
    a = a.reshape(-1, a.shape[-1]) if a.dim() else a.reshape(1, 1)
    b = b.reshape(-1, b.shape[-1]) if b.dim() else b.reshape(1, 1)
    rows = max(1, elems // a.shape[-1])
    for x, y in zip(a.split(rows), b.split(rows)):
        yield x.double(), y.double()


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in _row_chunks(a, b))


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


def enqueue_ms(fn, iters: int = 20) -> float:
    """Mean host ms to issue one call, the card idle before: where it
    reaches :func:`cuda_ms` of the same call, the events timed how fast
    the host issues the launches, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def timed_pair(name, kernel_fn, plain_fn, plain_iters=2, iters=10):
    """Time a kernel and its plain version on the same main-path inputs
    and hold the kernel's result to the plain one."""
    ms, got = cuda_ms(kernel_fn, iters)
    plain_ms, want = cuda_ms(plain_fn, plain_iters)
    err = check_close(f"{name} vs plain", got, want, KERNEL_TOL)
    return ms, plain_ms, err


def card_peaks() -> tuple[float, float, float]:
    """(HBM bytes/s, FP32 non-tensor FLOP/s, bf16 dense tensor-core
    FLOP/s): the data-sheet peaks of ``GPUTarget``, the H100 SXM."""
    from repro_torch.core.dse import GPUTarget

    t = GPUTarget()
    return t.hbm_gbs * 1e9, t.vpu_f32_tflops * 1e12, t.peak_bf16_tflops * 1e12


#: Flash kernel vs its plain version on the same card inputs: f32 at the
#: JAX kernel test's 2e-3 (scalar FMAs summed in another order), bf16 at
#: its 2e-2 (bf16 probabilities in P·V, bf16 output rounding).
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: The reference's flash test matrix (tests/test_kernels.py), run at D 128
#: (phase 6) and D 112 (phase 6h): (B, Hq, Hkv, Sq, Sk, causal, window).
FLASH_MATRIX = {
    "mha": (1, 2, 2, 128, 128, True, 0),
    "mqa": (2, 4, 1, 128, 128, True, 0),
    "gqa_prefix": (1, 4, 2, 64, 256, True, 0),
    "bidirectional": (1, 2, 2, 128, 128, False, 0),
    "window": (1, 2, 2, 256, 256, True, 64),
}
#: The Qwen3-8B, Zamba2-7B, Mixtral-8x7B and Kimi K2 prefills: prompts x
#: tokens, and their attention launch shape.
PREFILL = (4, 2048)
#: Mixtral-8x7B's second prefill: one prompt past its window of 4096, so
#: the kernel skips every key tile older than the window.
LONG_PREFILL = (1, 8192)
#: Mixtral-8x7B's depth on one card: 16 of its 32 layers (~43.8 GiB in
#: bf16; all 32 are 87.0 GiB), at full width.
MIXTRAL_LAYERS = 16
#: Kimi K2's depth on one card: its first (dense) layer and one MoE layer
#: of 384 experts and the shared expert (~36.5 GiB in bf16).
KIMI_LAYERS = 2
#: Full-width bf16 prefill through the kernel against the same model with
#: plain attention: both round each attention output to bf16 but at other
#: places inside, and the layers after it (36 of Qwen3-8B; up to 81 of
#: Zamba2-7B, whose 13 shared-block sites differ) carry the difference to
#: the logits; held as a relative L2 error of the logits at every
#: position, and apart on the positions past the window where it binds.
PREFILL_REL_L2 = 5e-2
#: ... or, where the model's own bf16 rounding noise is larger than that,
#: this many times the floor measured in the same run: the twin's logits
#: moved by a rounding-level change of every attention output
#: (:func:`rounding_noise`). Zamba2-7B's 81 bf16 layers put that floor
#: near 0.12: once two runs differ in one bit, every later layer rounds
#: differently (docs/port.md §hybrid). Each site's kernel output is held
#: to its plain version on its own inputs at ``FLASH_TOL`` besides.
FLOOR_FACTOR = 1.5
#: The noise runs' seeds: the first sets the floor, the others print its
#: spread.
NOISE_SEEDS = (3, 4, 5)
#: Decode logits against forward logits (tests/test_archs.py).
DECODE_TOL = dict(rtol=5e-2, atol=5e-2)
#: whisper-medium's prefill: clips x encoder frames (Whisper's 30-s
#: window), and a decoder of frames / 4 tokens (DESIGN.md §Shapes); both
#: lengths ragged against the kernel's tiles on purpose.
WHISPER = (8, 1500)
#: Teacher-forced f32 decode steps after prime_cross_cache, held to the
#: forward's first rows.
WHISPER_DECODE_STEPS = 32
#: f32 at full depth (24 + 24 layers): the kernel and its plain version
#: round the same f32 operations in another order, so the logits of the
#: two models, and the decode steps against the forward, agree far inside
#: this relative L2; no rounding floor is taken.
ENC_DEC_REL_L2 = 1e-3
#: LLaVA-NeXT-34B's prefill: one prompt of 2,880 frontend embeds
#: (n_frontend_tokens) and 1,216 tokens, at q 1x56x4096x128, kv
#: 1x8x4096x128 (GQA 7).
VLM_PREFILL = (1, 4096)
#: Memory kept free beside LLaVA-NeXT-34B's weights when its depth is
#: chosen: the prefill's activations, three (1, 4096, 64000) logits
#: tensors and the plain twin's f32 score chunks.
VLM_HEADROOM = 8 * 2**30
#: xLSTM-125m's prefill: prompts x tokens (16 chunks of 128).
SSM_PREFILL = (4, 2048)
#: f32 at full width and depth, over this many tokens: each block's chunked
#: apply against its step-by-step decode on the block's own input, at the
#: reference's tolerance for that pair (tests/test_models.py:80); and the
#: whole model's step-by-step decode against the chunked forward, argmax
#: equal at every position and within ``SSM_REL_L2`` (whisper's f32 gate).
#: The per-block tolerance does not hold for the logits after 12 blocks:
#: the random weights' later blocks amplify each block's ~1e-5 difference
#: to a few 1e-4 on unit-scale logits, in the reference's own f32 run too
#: (2.85e-4 max, one element of 2 x 128 x 50,304 outside it, on the CPU).
SSM_CONSISTENCY = 256
SSM_TOL = dict(rtol=2e-3, atol=2e-4)
SSM_REL_L2 = 1e-3
#: Phase 11a: xLSTM-125m trained at full width and depth, bf16 weights and
#: f32 AdamW: batch x tokens a step, and the reference's loop-test
#: schedule (tests/test_substrate.py): 12 steps, a checkpoint every 4,
#: faults after steps 6 and 9.
TRAIN_SSM = (8, 2048)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULTS = 12, 4, (6, 9)
#: The restarted run's losses after its last restore against the unbroken
#: run's same steps: the same data from a bitwise-restored state, but the
#: embedding backward's atomic adds sum in another order on each run, so
#: two runs of a step differ at the rounding level, far inside this.
TRAIN_LOSS_RTOL = 1e-3
#: Phase 11b: Qwen3-8B at full width and 8 of its 36 layers (2.79 B
#: parameters: ~33.5 GB of bf16 weights and gradients and f32 moments),
#: batch x tokens a step, and the steps of make_train_step.
QWEN_TRAIN_LAYERS = 8
TRAIN_DENSE = (2, 2048)
DENSE_STEPS = 3
#: Phase 11b under the reference's remat policies (``hint("remat")``):
#: steps under each policy after the default's, timed at the last.
REMAT_STEPS = 2
#: Phase 6p: Qwen3-8B's 36 layers pipelined over this many stages of a
#: stage mesh ``["cuda:0"] * stages``, on this many microbatches of
#: 1 x 2048 (PREFILL's prompts one at a time).
PIPE_STAGES, PIPE_MICRO = 4, 4
#: Phase 6e: the (data, model) mesh of the expert-parallel prefill over
#: ``["cuda:0"] * 8``, with the hints ``launch/dryrun.py`` passes.
EP_MESH = (2, 4)
#: Phase 6e in f32 at 2 layers and the no-drop capacity factor E/k (as
#: 6m(d)), one prompt of 2048: the expert products grouped by rank
#: against grouped by block, in f32 without TF32; held as a relative L2 of
#: the logits.
EP_F32_REL_L2 = 1e-5
#: Phase 11c: the data ranks of xLSTM-125m's 8 x 2048 batch, over
#: ``["cuda:0"] * ranks``, and the top-k scheme's kept fraction.
DP_RANKS, TOPK_FRAC = 2, 0.01
#: Step 0's gradient of every leaf through the kernel against plain
#: attention's, as a relative L2 (the logits gate's 5e-2), or where the
#: model's own bf16 rounding moves a leaf more, FLOOR_FACTOR x that
#: floor, measured in the same run.
GRAD_REL_L2 = 5e-2
#: Phase 6d: the dense configs served at full width, each at the deepest
#: depth that fits beside ``DENSE_HEADROOM`` and its prefill's three
#: logits tensors (nemotron-4-15b's (4, 2048, 256000) bf16 are 4.2 GB
#: each): the prefill's activations and the plain twin's f32 score chunks.
DENSE_SERVING = ("granite-34b", "nemotron-4-15b", "qwen2.5-32b")
DENSE_HEADROOM = 6 * 2**30
#: Phase 11d: the other families trained on one card, (config, layers
#: kept or None for all, batch x positions a step): Mixtral-8x7B's MoE
#: dispatch, Zamba2-7B's two shared-block sites under its group remat,
#: whisper-medium whole at its prefill shape (frames x 1500, 375 decoder
#: tokens), LLaVA-NeXT-34B's 2,880 embeds and 1,216 tokens (GQA 7).
TRAIN_FAMILIES = (("mixtral-8x7b", 2, TRAIN_DENSE),
                  ("zamba2-7b", 12, TRAIN_DENSE),
                  ("whisper-medium", None, WHISPER),
                  ("llava-next-34b", 4, VLM_PREFILL))
#: Phase 11f: Kimi K2 at the benchmark cell's cut (``bench/configs/
#: kimi-k2-5l.json``): the dense layer and 4 expert layers, 8 of 384
#: experts held, a vocabulary slice of 20,480, 2x8192 tokens a step.
MLA_TRAIN_LAYERS = 5
MLA_HELD = 8
MLA_VOCAB = 20480
MLA_TRAIN = (2, 8192)
#: Phase 11f: the (192, 128) kernels against their plain versions at the
#: card tests' tolerances (tests/test_torch_cuda.py): the LSE within
#: 1e-5, dq, dk and dv each within 2e-3 in relative L2 (measured ~3e-4).
MLA_LSE_TOL = dict(rtol=1e-5, atol=1e-5)
MLA_GRAD_REL_L2 = 2e-3


#: ptxas spill bytes allowed per kernel instantiation, by stream library:
#: none. Any spill of any stream kernel fails phase 1 (the uLBM program's
#: collide+stream cluster, which once spilled 56 bytes at the 64-register
#: cap of its 1,024-thread block, included; docs/port.md §program).
SPILL_ALLOWANCE: dict[str, int] = {}


def flash_census(build) -> None:
    """Phase 1's view of the compiled flash library: ptxas's registers and
    spill bytes for each kernel (the forward's and the backward's, one of
    each at every (D, Dv) of ``HOPPER_DIMS``), and
    the SASS counts of the Hopper instructions (HGMMA: wgmma, UTMALDG: TMA
    loads, SYNCS: mbarriers). Fails when the Hopper kernels or the
    backward's spill or lack wgmma or TMA."""
    import re
    import shutil

    from repro_torch.kernels.flash_attention.flash_attention import (
        HOPPER_DIMS,
    )

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
        m = re.search(r"(hopper|simple)12(flash|probe)_kernelI.*?Li(\d+)E"
                      r"(?:Li(\d+)E)?", name)
        if not m:
            continue
        dtype = "f32" if "flash_kernelIfLi" in name else "bf16"
        label = (f"{m.group(1)}::{m.group(2)}_kernel<{dtype}, "
                 f"D {m.group(3)}"
                 + (f", Dv {m.group(4)}" if m.group(4) else "") + ">")
        phase(f"  ptxas {label}: {info.get('regs')} registers, "
              f"{info.get('spill')} spill bytes")
        if m.group(1) == "hopper" and m.group(2) == "flash":
            hopper += 1
            if info.get("spill") != 0:
                fail(f"{label} spills {info.get('spill')} bytes")
    if hopper != len(HOPPER_DIMS):
        fail(f"ptxas log lists {hopper} Hopper flash kernels, expected "
             f"{len(HOPPER_DIMS)} (D, Dv) {HOPPER_DIMS}")
    # the backward's kernels: the D pre-pass, dK dV and dQ at each pair
    backward = 0
    for name, info in sorted(kernels.items()):
        m = re.search(r"hopper\d+(flash_bwd_\w+?_kernel)"
                      r"(?:ILi(\d+)ELi(\d+)E)?", name)
        if not m:
            continue
        backward += 1
        label = f"hopper::{m.group(1)}" + (
            f"<D {m.group(2)}, Dv {m.group(3)}>" if m.group(2) else "")
        phase(f"  ptxas {label}: {info.get('regs')} registers, "
              f"{info.get('spill')} spill bytes")
        if info.get("spill") != 0:
            fail(f"{label} spills {info.get('spill')} bytes")
    if backward != 1 + 2 * len(HOPPER_DIMS):
        fail(f"ptxas log lists {backward} backward kernels, expected "
             f"{1 + 2 * len(HOPPER_DIMS)} (the D pre-pass; dK dV and dQ at "
             f"each (D, Dv) of {HOPPER_DIMS})")
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
    bytes for every kernel of every library, then a failure on any spill
    beyond the library's :data:`SPILL_ALLOWANCE` (0 where it has none)."""
    spills, allowed = [], []
    for lib, src in sources.items():
        log = build.library_path(lib, src).with_suffix(".log").read_text()
        usage = build.ptxas_usage(log)
        if not usage:
            fail(f"ptxas log of {lib} lists no kernel")
        for name, (regs, spill) in sorted(usage.items()):
            phase(f"  ptxas {lib} {name}: {regs} registers, {spill} spill "
                  "bytes")
            if spill > SPILL_ALLOWANCE.get(lib, 0):
                spills.append(f"{lib} {name} spills {spill} bytes")
            elif spill:
                allowed.append(f"{lib} {name} {spill} B")
    phase(f"  stream kernels' spills within their allowance "
          f"({SPILL_ALLOWANCE or 'none'}): {allowed or 'none'}")
    if spills:
        fail("; ".join(spills))


#: Phase 2b's batches: (app, (H, W), B values, m, block_h); the uLBM PE
#: 4096² batch of 13 members passes 2^31 floats (its member bases are
#: 64-bit).
BATCHES = (("diffusion", (2048, 2048), (1, 3, 8), 4, 32),
           ("cavity", (300, 720), (1, 3, 8), 4, 20),
           ("tgv", (4096, 4096), (13,), 4, 16))


def batched_launches(hbm: float, fp32: float) -> None:
    """Phase 2b: both periodic launches over ``(B, P, H, W)`` batches at
    :data:`BATCHES`. Every member is held bitwise to its own 3-D launch,
    B 3 and B 8 to the plain version (not B 13: its plain version would
    gather 13 grids of 4096² tiles), and each launch timed with CUDA
    events against its bound (``2·B·P·H·W·4`` bytes); diffusion beside
    four circular pads and ``conv2d`` with N = B. The kernels line's
    batched rows come from phase 9, at the plans the serving path
    pins."""
    import torch
    import torch.nn.functional as F

    from repro_torch.apps import diffusion as dif
    from repro_torch.apps import lbm
    from repro_torch.kernels.spd_stream.spd_stream import (
        spd_multistep,
        spd_multistep_plain,
    )
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_streamed,
    )

    phase("phase 2b: the batch axis: each member == its own launch, B 3 and "
          "B 8 == plain, CUDA events")
    gen = torch.Generator(device="cpu").manual_seed(19)

    def noisy(x):
        return x * (1 + 0.01 * torch.randn(x.shape, generator=gen)
                    .to(x.device))

    for app, (h, w), bs, m, bh in BATCHES:
        members = None
        if app == "diffusion":
            label = f"diffusion {h}x{w}"
            sim = dif.DiffusionSimulation(h, w)
            kern, regs = sim.kernel, (0.2,)
            u0, _ = dif.sine_init(h, w)
            members = [sim.state(noisy(u0)) for _ in range(max(bs))]
        elif app == "cavity":
            label = f"uLBM PE {h}x{w} cavity"
            sim = lbm.LBMSimulation(lbm.LBMProblem(h, w, u_lid=0.05))
            kern, regs = sim.stream_kernel(), sim.stream_regs()
            f, attr = lbm.cavity_init(h, w)
            members = [sim.stream_state(noisy(f), attr)
                       for _ in range(max(bs))]
        else:
            label = f"uLBM PE {h}x{w} TGV"
            sim = lbm.LBMSimulation(lbm.LBMProblem(h, w))
            kern, regs = sim.stream_kernel(), sim.stream_regs()
            f, attr, _ = lbm.taylor_green_init(h, w)
        flops = sim.hardware_report.flops
        prog = kern.program
        for b in bs:
            if members is None:
                # made in place: 13 members of 671 MB at 4096^2
                batch = torch.empty((b, 10, h, w), device=f.device)
                for i in range(b):
                    batch[i, :9] = f * (1 + 0.001 * i)
                    batch[i, 9] = attr
                one = [batch[i] for i in range(b)]
            else:
                batch = kern.pack_batch(members[:b])
                one = members[:b]
            _, p, h, w = batch.shape
            nbytes, ops = 2 * batch.numel() * 4, flops * m * b * h * w
            bound = max(nbytes / hbm, ops / fp32) * 1e3
            lib_ms = None
            if app == "diffusion":
                a = 0.2
                w5 = torch.tensor([[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]],
                                  dtype=torch.float32,
                                  device=batch.device).view(1, 1, 3, 3)

                def conv_steps():
                    x = batch
                    for _ in range(m):
                        x = F.conv2d(F.pad(x, (1, 1, 1, 1),
                                           mode="circular"), w5)
                    return x

                lib_ms, _ = cuda_ms(conv_steps)
            out = torch.empty_like(batch)
            single = torch.empty_like(batch[0])
            for fn in (spd_multistep_streamed, spd_multistep):
                streamed = fn is spd_multistep_streamed
                bw, db = kern.tile(w, bh, m, double_buffer=streamed,
                                   streamed=streamed)
                kw = {"double_buffer": db} if streamed else {}
                ms, got = cuda_ms(lambda: fn(prog, batch, regs, m=m,
                                             block_h=bh, block_w=bw,
                                             out=out, **kw),
                                  3 if b > 8 else 10)
                for i in range(b):
                    if not torch.equal(got[i], fn(prog, one[i], regs, m=m,
                                                  block_h=bh, block_w=bw,
                                                  out=single, **kw)):
                        fail(f"{label} B {b} {fn.__name__}: member {i} != "
                             "its own launch")
                tag = f"{label} B {b} {fn.__name__} (block {bh}x{bw}, m {m})"
                line = (f"  {tag}: {ms:.4f} ms/launch ({ms / b:.4f} per "
                        f"member), bound {bound:.4f} ms ({bound / ms:.1%}), "
                        f"every member == its own launch")
                if b in (3, 8):
                    plain_ms, want = cuda_ms(
                        lambda: spd_multistep_plain(prog, batch, regs, m=m,
                                                    block_h=bh, block_w=bw),
                        1)
                    check_equal(f"{tag} vs plain", got, want)
                    line += f", plain {plain_ms:.2f} ms"
                    del want
                if lib_ms is not None:
                    line += f", library {lib_ms:.4f} ms"
                phase(line)
            del batch, out, single, got, one
            torch.cuda.empty_cache()
        del members, sim, kern


def sim_serving(record) -> None:
    """Phase 9: the simulation-serving engine on the card (docs/port.md
    §serve). The launch counts are set to 0 just before, and read just
    after, each of: the cold engine (its tuning timings and its serving),
    the warm engine's ``serve_traffic`` (the serving path: the kernels
    line's streamed rows), the sync-debug tick, the CLI's serve and the
    declarative twin (the kernels line's declarative rows; the serving
    path never runs that launch). Each batched row is timed at the plans
    the serving path pinned for its core, a full cohort of b members."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import cli
    from repro_torch.core.codegen import StripeProgram
    from repro_torch.kernels.spd_stream.spd_stream import (
        spd_multistep,
        spd_multistep_plain,
    )
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_streamed,
    )
    from repro_torch.serve.sim import PlanResolver, SimEngine, SimRequest

    phase("phase 9: simulation serving on the card: uLBM PE 300x720 cavity, "
          "diffusion 2048^2 alpha 0.2 and 0.1; 8 requests x 64 steps each, "
          "Poisson arrivals at 8 per tick")
    t9 = time.perf_counter()
    mix = cli.serve_mix("cuda", lbm_grid=(300, 720), lbm_init="cavity",
                        diffusion=((2048, 2048, 0.2), (2048, 2048, 0.1)))
    tmp = tempfile.mkdtemp(prefix="phase9-")

    def resolver():
        return PlanResolver(budget=4, b_values=(1, 2, 4, 8),
                            bh_values=(8, 16, 32, 64),
                            m_values=(1, 2, 4, 8), study_dir=tmp)

    def group_of(eng, t):
        _, kern, _, regs = mix[t]
        return next(g for g in eng.groups.values() if g.kern is kern
                    and g.ctx.regs == tuple(float(r) for r in regs))

    def zero():
        spd_multistep_streamed.launches = 0
        spd_multistep.launches = 0
        StripeProgram.launches.clear()

    def taken(what: str) -> dict:
        """``{wrapper[core]: launches}`` since :func:`zero`, printed."""
        fns = [fn for fn in (spd_multistep_streamed, spd_multistep)
               if fn.launches]
        if len(fns) > 1:
            fail(f"phase 9 {what}: both launches ran in one window")
        got = {f"{fns[0].__name__}[{k}]": n
               for k, n in sorted(StripeProgram.launches.items())} \
            if fns else {}
        phase(f"  launches {what}: {got}")
        return got

    runs = {}
    try:
        for run in ("cold", "warm"):
            eng = SimEngine(resolver())
            torch.cuda.synchronize()
            zero()
            done, owner = cli.serve_traffic(eng, mix, requests=8, steps=64,
                                            rate=8.0, seed=0)
            counts = taken("on the serving path (the warm engine's "
                           "serve_traffic)" if run == "warm" else
                           "by the cold engine (tuning timings and serving)")
            cells = {rid: mix[t][2].shape[-2] * mix[t][2].shape[-1]
                     for rid, t in owner.items()}
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                stats = cli.serve_report(eng, done, cells)
            for line in text.getvalue().splitlines():
                phase(f"  {run}: {line}")
            kernel = sum(counts.values())
            phase(f"  {run}: {kernel} kernel launches ({eng.launches} "
                  "engine launches, the rest tuning timings)")
            if stats["completed"] != 24 or stats["submitted"] != 24:
                fail(f"phase 9 {run}: {stats['completed']}/"
                     f"{stats['submitted']} completed")
            if kernel < eng.launches or spd_multistep.launches:
                fail(f"phase 9 {run}: {eng.launches} engine launches but "
                     f"{kernel} kernel launches of spd_multistep_streamed: "
                     "a launch ran the plain version")
            runs[run] = (eng, done, owner, stats, counts)
        cold, warm = runs["cold"], runs["warm"]
        served = warm[4]
        if max(int(k) for k in cold[3]["occupancy"]) < 2:
            fail(f"phase 9: no launch wider than 1 ({cold[3]['occupancy']})")
        if warm[3]["live_timings"] or sum(served.values()) != warm[0].launches:
            fail(f"phase 9 warm: {warm[3]['live_timings']} live timings, "
                 f"{sum(served.values())} kernel launches for "
                 f"{warm[0].launches} engine launches (want 0 and equal)")
        # A warm plan is its journal's decision. Contexts of one core and
        # grid (the two diffusion tenants) share one journal by design, so
        # that offline sweeps warm serving: each cold context chose from
        # the timings it saw, the warm ones replay the same journal and
        # pin one plan. A context alone on its journal pins its cold plan.
        studies: dict = {}
        for ctx in warm[0].groups:
            studies.setdefault(warm[0].resolver.study_name(ctx), []).append(
                SimEngine._plan_key(ctx))
        for keys in studies.values():
            for key in keys:
                got = warm[3]["plans"][key]
                want = (cold[3]["plans"][key] if len(keys) == 1
                        else warm[3]["plans"][keys[0]])
                if any(got[k] != want[k] for k in ("block_h", "m", "b",
                                                    "double_buffer")):
                    fail(f"phase 9: warm plan {got} != {want} ({key}; "
                         f"journal shared with {keys})")

        # One tick of a cohort in flight under set_sync_debug_mode: no
        # admission, no dissolution, one launch and no wait after it.
        eng = SimEngine(resolver())
        _, kern, state, regs = mix[0]
        zero()
        for i in range(8):
            eng.submit(SimRequest(rid=i, core=kern, state=state, steps=64,
                                  regs=regs))
        eng.step()
        torch.cuda.synchronize()
        n = eng.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        width = len(group_of(eng, 0).cohort.members)
        if eng.launches != n + 1 or out or eng.queue:
            fail("phase 9: the sync-debug tick did not launch one cohort")
        phase(f"  one tick under set_sync_debug_mode('error'): one launch "
              f"of width {width}, no host sync")
        eng.run_until_drained()
        taken("by the sync-debug engine")

        # The CLI's serve on the card, warm from the same studies.
        text = io.StringIO()
        zero()
        with contextlib.redirect_stdout(text):
            cstats = cli.main(["serve", "--study-dir", tmp,
                               "--json", os.path.join(tmp, "serve.json")])
        taken("by the CLI's serve")
        for line in text.getvalue().splitlines()[-9:]:
            phase(f"  cli serve: {line}")
        if cstats["completed"] != 24 or cstats["live_timings"] != 0:
            fail(f"phase 9 cli serve: {cstats['completed']} completed, "
                 f"{cstats['live_timings']} live timings")

        # The declarative twin, not on the serving path: one full cohort
        # of each context (b members) through spd_multistep at the pinned
        # plan.
        eng = warm[0]
        plans = {t: group_of(eng, t).plan for t in range(len(mix))}
        twins = {}
        zero()
        for t, (name, kern, state, regs) in enumerate(mix):
            batch = kern.pack_batch([state] * plans[t].b)
            for _ in range(64 // plans[t].m):
                batch = kern.multistep(batch, regs, m=plans[t].m,
                                       block_h=plans[t].block_h)
            twins[t] = batch
        twin = taken("by the declarative twin (a full cohort of each "
                     "context at its pinned plan)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Every completion of both engines, and every member of the twin, ==
    # its own run_blocked at the pinned plan from the same initial state,
    # on the CPU: the plain version.
    for t, (name, kern, state, regs) in enumerate(mix):
        plan = plans[t]
        ref = kern.run_blocked(
            state.cpu(), regs, steps=64, m=plan.m, block_h=plan.block_h,
            double_buffer=plan.double_buffer).numpy()
        for i in range(plan.b):
            if not np.array_equal(twins[t][i].cpu().numpy(), ref):
                fail(f"phase 9 {name}: declarative twin member {i} != "
                     "the plain run_blocked")
        for run, (_, done, owner, _, _) in runs.items():
            mine = [c for c in done if owner[c.rid] == t]
            for c in mine:
                if not np.array_equal(c.state, ref):
                    fail(f"phase 9 {run}: request {c.rid} != its own "
                         "run_blocked at the pinned plan")
            phase(f"  {run} {name}: every completion ({len(mine)}) == its "
                  f"own run_blocked on the CPU (the plain version) at the "
                  f"pinned plan (b {plan.b}, m {plan.m}, block_h "
                  f"{plan.block_h}): bitwise equal")
    del twins

    # The batched rows: each core's launches at the plans the serving
    # path pinned for it, a full cohort of b members, beside the plain
    # version and, for diffusion, m circular pads and conv2d with N = b.
    cores = {}
    for t, (name, kern, state, regs) in enumerate(mix):
        cores.setdefault(kern.program.name, []).append(t)
    for core, ts in cores.items():
        for fn, counts in ((spd_multistep_streamed, served),
                           (spd_multistep, twin)):
            streamed = fn is spd_multistep_streamed
            key = f"{fn.__name__}[{core}]"
            if counts.get(key, 0) < 1:
                fail(f"kernel {key} was not launched in phase 9")
            times, labels = [], []
            # the plans of the core's contexts, once each (the declarative
            # launch does not prefetch)
            pinned = {(plans[t].b, plans[t].m, plans[t].block_h,
                       streamed and plans[t].double_buffer): t for t in ts}
            for (b, m, bh, db), t in pinned.items():
                name, kern, state, regs = mix[t]
                prog = kern.program
                batch = kern.pack_batch([state] * b)
                _, _, h, w = batch.shape
                bw, db = kern.tile(w, bh, m, double_buffer=db,
                                   streamed=streamed)
                kw = {"double_buffer": db} if streamed else {}
                buf = torch.empty_like(batch)
                ms, got = cuda_ms(lambda: fn(prog, batch, regs, m=m,
                                             block_h=bh, block_w=bw,
                                             out=buf, **kw))
                plain_ms, want = cuda_ms(
                    lambda: spd_multistep_plain(prog, batch, regs, m=m,
                                                block_h=bh, block_w=bw), 1)
                label = (f"{name} B {b} {fn.__name__} (m {m}, block "
                         f"{bh}x{bw}" + (f", db {db}" if streamed else "")
                         + ")")
                check_equal(f"{label} vs plain", got, want)
                lib_ms = None
                if core == "Diff2D":
                    a = regs[0]
                    w5 = torch.tensor(
                        [[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]],
                        dtype=torch.float32, device=batch.device,
                    ).view(1, 1, 3, 3)

                    def conv_steps():
                        x = batch
                        for _ in range(m):
                            x = F.conv2d(F.pad(x, (1, 1, 1, 1),
                                               mode="circular"), w5)
                        return x

                    lib_ms, _ = cuda_ms(conv_steps)
                times.append((ms, plain_ms, max_err(got, want),
                              2 * batch.numel() * 4,
                              kern.compiled.hardware_report.flops * m * b
                              * h * w, lib_ms))
                labels.append(f"B {b}, m {m}, block_h {bh}")
                phase(f"  {label}: {ms:.4f} ms/launch, plain {plain_ms:.2f} "
                      "ms" + (f", library {lib_ms:.4f} ms" if lib_ms else ""))
                del batch, buf, got, want
            # one row a core; contexts that pinned different plans are
            # named in it and averaged
            ms, plain_ms, _, nbytes, ops = (
                sum(x[i] for x in times) / len(times) for i in range(5))
            libs = [x[5] for x in times if x[5] is not None]
            record(f"{key} ({' | '.join(labels)})",
                   "src/repro_torch/csrc/spd_stream.cuh",
                   "src/repro/kernels/spd_stream/streaming.py:180"
                   if streamed
                   else "src/repro/kernels/spd_stream/spd_stream.py:65",
                   counts[key], ms, plain_ms, nbytes, ops,
                   max(x[2] for x in times),
                   sum(libs) / len(libs) if libs else None)
    torch.cuda.empty_cache()
    phase(f"  phase 9: {time.perf_counter() - t9:.1f} s")


def l2_sums(got, want) -> tuple[float, float]:
    """(sum (got - want)², sum want²) in f64, piece by piece."""
    num = den = 0.0
    for x, y in _row_chunks(got, want):
        num += float(((x - y) ** 2).sum())
        den += float((y * y).sum())
    return num, den


def rel_l2(got, want) -> float:
    num, den = l2_sums(got, want)
    return math.sqrt(num / den)


@contextlib.contextmanager
def attention_through(fn):
    """Route the models' attention (``models.layers._attention``, which
    every ``attention_block`` calls) through ``fn(orig, q, k, v, **kw)``
    while the block runs."""
    from repro_torch.models import layers

    orig = layers._attention
    layers._attention = lambda q, k, v, **kw: fn(orig, q, k, v, **kw)
    try:
        yield
    finally:
        layers._attention = orig


@contextlib.contextmanager
def routing_recorded(sink: list):
    """Append each MoE layer's top-k experts (``(N, k)``, sorted per
    token) to ``sink`` while the block runs."""
    from repro_torch.models import layers

    orig = layers.moe_route

    def record(p, xt, cfg, *rest):
        plan = orig(p, xt, cfg, *rest)
        sink.append(plan[1].sort(-1).values)
        return plan

    layers.moe_route = record
    try:
        yield
    finally:
        layers.moe_route = orig


@contextlib.contextmanager
def drops_recorded(sink: list):
    """Append each MoE dispatch's dropped assignments per block (the
    two-stage ``moe_route``) or per rank (``moe_ep_apply``, with its
    all-to-all bytes) to ``sink`` while the block runs."""
    from repro_torch.models import layers
    from repro_torch.parallel import moe_ep

    route, ep = layers.moe_route, moe_ep.moe_ep_apply

    def record_route(p, xt, cfg, nblk=1):
        plan = route(p, xt, cfg, nblk)
        sink.append({"dropped": (~plan[3]).view(nblk, -1).sum(1)})
        return plan

    def record_ep(*args, **kwargs):
        out = ep(*args, **kwargs)
        sink.append(dict(ep.last))
        return out

    layers.moe_route, moe_ep.moe_ep_apply = record_route, record_ep
    try:
        yield
    finally:
        layers.moe_route, moe_ep.moe_ep_apply = route, ep


def rounding_noise(seed: int):
    """An attention wrapper that moves each output at the level of its own
    rounding: every value scaled by 1 + u 2^-8, u uniform in [-1, 1] from
    one generator seeded by ``seed``, and rounded back to its dtype."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def moved(orig, q, k, v, **kw):
        o = orig(q, k, v, **kw)
        u = torch.rand(o.shape, generator=g, device=o.device) * 2 - 1
        return (o.float() * (1 + u * 2.0 ** -8)).to(o.dtype)

    return moved


def keyed_noise(seed: int):
    """:func:`rounding_noise` with ``u`` a hash of each output element's
    index, its bits and ``seed`` instead of a generator's next draw: the
    same output is moved the same way however often it is computed, so a
    backward that runs a site's forward again (remat) sees the forward's
    noise."""
    import torch

    def moved(orig, q, k, v, **kw):
        o = orig(q, k, v, **kw)
        # a 32-bit mix in int64, masked before each product so that
        # nothing overflows
        m32 = 0xFFFFFFFF
        bits = o.float().view(torch.int32).long() & m32
        idx = torch.arange(o.numel(), device=o.device).view(o.shape)
        x = ((idx * 0x9E3779B1) & m32) ^ bits ^ (seed * 0x2545F491)
        x = ((x ^ (x >> 16)) * 0x7FEB352D) & m32
        x = ((x ^ (x >> 15)) * 0x5BD1E995) & m32
        x = x ^ (x >> 16)
        u = (x & 0xFFFFFF).float() / 2.0 ** 23 - 1
        return (o.float() * (1 + u * 2.0 ** -8)).to(o.dtype)

    return moved


@contextlib.contextmanager
def routing_fixed(table: dict, flips: list):
    """Hold every MoE layer's top-k experts to ``table`` (the router's
    module -> ``(N, k)`` experts) while the block runs: a layer not in it
    yet records its own; one in it keeps the recorded experts, its gates
    recomputed from its own router logits (so the router's gradient flows
    as in :func:`moe_router`), and appends to ``flips`` how many of its
    assignments its own top-k would have changed. A bf16 tie can flip an
    expert between two runs that differ at the rounding level; held fixed,
    the two gradients differ only where the runs do."""
    import torch

    from repro_torch.models import layers

    orig = layers.moe_router

    def fixed(p, xt, cfg):
        # every call runs the same ops, the first too: remat's recompute
        # must save what the forward saved
        with torch.no_grad():
            idx = orig(p, xt, cfg)[1]
        want = table.setdefault(p, idx)
        flips.append(int((idx.sort(-1).values != want.sort(-1).values)
                         .sum()))
        probs = torch.softmax(xt.float() @ p.router, dim=-1)
        gates = probs.gather(-1, want)
        return gates / torch.clamp(gates.sum(-1, keepdim=True),
                                   min=1e-9), want

    layers.moe_router = fixed
    try:
        yield
    finally:
        layers.moe_router = orig


def flash_vs_plain(d: int, g) -> list:
    """The flash kernel against its plain version at head dim ``d``: the
    reference's test matrix in f32 and bf16, and two block shapes, bitwise
    equal to each other. Returns the max abs errors."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    errs = []
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for case, (b, hq, hkv, sq, sk, causal, window) in FLASH_MATRIX.items():
            q, k, v = flash_inputs(g, b, hq, hkv, sq, sk, d, dtype)
            kw = dict(causal=causal, window=window)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            errs.append(check_close(
                f"flash D {d} {case} {dname}", got.float(), want.float(),
                FLASH_TOL[dname]))
        q, k, v = flash_inputs(g, 1, 2, 2, 128, 256, d, dtype)
        a = flash_attention(q, k, v, block_q=64, block_k=64)
        b = flash_attention(q, k, v, block_q=128, block_k=128)
        check_equal(f"flash D {d} {dname} blocks 64x64 == 128x128", a, b)
        errs.append(check_close(
            f"flash D {d} {dname} blocks 64x64 vs plain", a.float(),
            flash_attention_plain(q, k, v).float(), FLASH_TOL[dname]))
    return errs


def flash_inputs(g, b, hq, hkv, sq, sk, d, dtype):
    """Seeded q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) on the card."""
    import torch

    mk = lambda h, s: torch.randn(  # noqa: E731
        (b, h, s, d), generator=g, device="cuda").to(dtype)
    return mk(hq, sq), mk(hkv, sk), mk(hkv, sk)


def kept_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends to: the mask of ``_mask`` in
    ``kernels/flash_attention/ref.py`` (diagonal at ``sk - sq``)."""
    total = 0
    for i in range(sk - sq, sk):
        hi = i + 1 if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def prefill_check(cfg, bundle, plain, model, shape, sites: int,
                  seed: int) -> dict:
    """The prefill step of ``model`` on ``shape`` (prompts x positions,
    seeded tokens; a VLM's frontend embeds and an audio model's frames,
    ``shape[1]`` of them, and its ``shape[1] / 4`` tokens, from
    ``registry.make_batch``): its wall, tokens/s and peak memory, the
    flash launches counted from 0 (``sites`` expected) and apart by launch
    shape, each site's kernel output against its plain version on that
    site's own q, k and v, and the logits against the plain-attention
    twin ``plain`` beside the twin's own rounding floor: at every
    position, and apart past the window where it binds; for an MoE model
    also the tokens whose top-k experts differ from the twin's."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.models import registry

    dev = "cuda"
    b, s = shape
    prefill = bundle.make_prefill_step()
    if cfg.family in ("vlm", "audio"):
        batch = registry.make_batch(cfg, ShapeConfig("prefill", s, b,
                                                     "prefill"), seed, dev)
    else:
        tok_gen = torch.Generator(device=dev).manual_seed(seed)
        batch = {"tokens": torch.randint(1, cfg.vocab, shape,
                                         generator=tok_gen, device=dev)}
    prefill(model, {k: x[:1, :128] for k, x in batch.items()})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # The launches apart by (Sq, Sk, causal): the kernel's own count
    # before and after each site.
    by_shape: dict = {}

    def tally(orig, q, k, v, **kw):
        n = flash_attention.launches
        o = orig(q, k, v, **kw)
        key = (q.shape[2], k.shape[2], kw["causal"])
        by_shape[key] = by_shape.get(key, 0) + flash_attention.launches - n
        return o

    flash_attention.launches = 0
    with attention_through(tally):
        t0 = time.perf_counter()
        nxt = prefill(model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"launches": flash_attention.launches, "wall": wall,
           "by_shape": by_shape, "batch": batch}
    phase(f"  launches on the {cfg.name} prefill path ({b}x{s}): "
          f"{{'flash_attention': {out['launches']}}}, by (Sq, Sk, causal) "
          f"{by_shape}")
    if out["launches"] != sites:
        fail(f"flash_attention launched {out['launches']} times in the "
             f"{cfg.name} prefill {b}x{s}, expected {sites}")
    if nxt.shape != (b, cfg.vocab) or not torch.isfinite(nxt).all():
        fail(f"prefill logits: shape {tuple(nxt.shape)} or non-finite")
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    # Each site's kernel output against the plain version on the same q,
    # k and v: the prefill's own activations (a second, uncounted run).
    seen = []

    def capture(orig, q, k, v, **kw):
        o = orig(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, causal=kw["causal"],
                                     window=kw["window"])
        seen.append((max_err(o, want), torch.allclose(
            o.float(), want.float(), **FLASH_TOL["bfloat16"])))
        return o

    kernel_routes = []
    with attention_through(capture), routing_recorded(kernel_routes):
        full = bundle.forward(model, batch)
    phase(f"  each of the {len(seen)} sites' kernel output vs plain on its "
          f"own q, k, v: max abs err {max(e for e, _ in seen):.3e} "
          f"(rtol/atol {FLASH_TOL['bfloat16']['atol']})")
    if len(seen) != sites or not all(ok for _, ok in seen):
        fail(f"{cfg.name} prefill sites vs plain: {seen}")
    out["errs"] = [e for e, _ in seen]
    # The timed prefill's next-token logits are the forward's last row.
    last = (slice(None), -1)
    if not torch.equal(full[last], nxt):
        fail(f"{cfg.name} prefill {b}x{s}: the timed prefill's next-token "
             f"logits != the forward's last row (max abs err "
             f"{max_err(full[last], nxt)})")
    # The logits against the plain-attention twin at every position, and
    # apart on the rows past the window where it binds, each beside the
    # twin moved by a rounding-level change of every attention output
    # (the floor, seed NOISE_SEEDS[0]; the others print its spread). The
    # next token is printed but not gated: in an MoE model such a change
    # flips some tokens' top-k experts, and a flipped token's logits move
    # by a step, so one row's floor is a coin toss (the flips are counted
    # below; docs/port.md §moe).
    regions = {"every position": (slice(None), slice(None))}
    w = cfg.sliding_window
    if w and s > w:
        regions[f"positions >= {w}"] = (slice(None), slice(w, None))
    plain_routes = []
    with routing_recorded(plain_routes):
        want = plain.forward(model, batch)
    floors = {r: [] for r in [*regions, "next token"]}
    noise_routes = []
    for noise_seed in NOISE_SEEDS:
        noise_routes.append([])
        with attention_through(rounding_noise(noise_seed)), \
                routing_recorded(noise_routes[-1]):
            moved = plain.forward(model, batch)
        for r, ix in [*regions.items(), ("next token", last)]:
            floors[r].append(rel_l2(moved[ix], want[ix]))
        del moved
    spread = lambda fl: ", ".join(  # noqa: E731
        f"{x:.3e}" for x in fl)
    rate = (f"{b * s / wall:.0f} frames/s and {b * (s // 4) / wall:.0f} "
            "tokens/s" if "frames" in batch else f"{b * s / wall:.0f} "
            "tokens/s")
    depth = (f"{cfg.n_layers} + {cfg.n_layers}" if cfg.enc_dec
             else cfg.n_layers)
    phase(f"  {cfg.name} prefill {b}x{s} ({depth} layers, "
          f"{cfg.num_params():.0f} parameters"
          f"{f', window {w}' if w else ''}): {wall * 1e3:.1f} ms, "
          f"{rate}, peak memory {out['peak']:.2f} GiB "
          f"(from after the warm-up, weights included)")
    bad = []
    for r, ix in regions.items():
        rel = rel_l2(full[ix], want[ix])
        limit = max(PREFILL_REL_L2, FLOOR_FACTOR * floors[r][0])
        phase(f"    logits vs plain attention, {r}: rel L2 {rel:.3e} (<= "
              f"{limit:.3e}: the larger of {PREFILL_REL_L2} and "
              f"{FLOOR_FACTOR} x the rounding floor; floors at seeds "
              f"{NOISE_SEEDS}: {spread(floors[r])}), max abs err "
              f"{max_err(full[ix], want[ix]):.3e}")
        if not rel <= limit:
            bad.append(f"{r}: rel L2 {rel} (limit {limit})")
    agree = int((nxt.argmax(-1) == want[last].argmax(-1)).sum())
    phase(f"    next token (== the forward's last row, bitwise): rel L2 "
          f"{rel_l2(nxt, want[last]):.3e}, floors "
          f"{spread(floors['next token'])} (not gated), argmax agrees on "
          f"{agree}/{b}")
    if plain_routes:
        # Tokens whose top-k experts differ from the plain run's, over all
        # MoE layers, and among them the prompts' last positions.
        def flips(routes):
            tok = pos = 0
            for x, y in zip(routes, plain_routes):
                diff = (x != y).any(-1)
                tok += int(diff.sum())
                pos += int(diff.view(b, s)[:, -1].sum())
            return tok, pos

        runs = {"kernel run": flips(kernel_routes)} | {
            f"noise seed {n}": flips(r)
            for n, r in zip(NOISE_SEEDS, noise_routes)}
        phase(f"    top-k experts != the plain run's, of {b * s} tokens x "
              f"{len(plain_routes)} MoE layers (last positions: of "
              f"{b} x {len(plain_routes)}): " + "; ".join(
                  f"{run} {t} ({p})" for run, (t, p) in runs.items()))
    if bad:
        fail(f"{cfg.name} prefill {b}x{s} logits vs plain attention: "
             + "; ".join(bad))
    out["floor"] = floors["every position"][0]
    return out


def lm_serving(cfg, label: str, f32_layers: int, *,
               prefills=(PREFILL,), matrix: bool = True,
               engine: bool = True, f32_changes: dict | None = None,
               resident=None) -> dict:
    """Phases 6 (Qwen3-8B), 6h (Zamba2-7B), 6m (Mixtral-8x7B) and 6k
    (Kimi K2), and through ``resident`` 6p and 6e: (a) the flash
    kernel against its plain version at the
    model's head dim (the reference's matrix with ``matrix``) and at each
    prefill's launch shape; (b) each prefill of ``cfg`` at full width
    (:func:`prefill_check`); (c) with ``engine``, the engine at full
    width; (d) with ``f32_layers``, the f32 greedy check at that depth,
    its config changed by ``f32_changes``. ``resident(cfg, bundle, model,
    out)`` runs after (b) on the same model (phases 6p and 6e), and its
    result is kept under ``out["resident"]``. Returns, per prefill shape, the
    numbers phase 5's flash rows need."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.models import registry
    from repro_torch.models.zamba2 import schedule
    from repro_torch.serve.engine import Request, ServeEngine

    t6 = time.perf_counter()
    phase(f"{label}: LM serving, {cfg.name} ({cfg.family})")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    # the prefill's attention launches: every layer, or each site of the
    # hybrid's shared block
    sites = schedule(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers

    # (a) the kernel against its plain version
    errs = flash_vs_plain(cfg.head_dim, g) if matrix else []
    out = {}
    for b, s in prefills:
        q, k, v = flash_inputs(g, b, cfg.n_heads, cfg.n_kv_heads, s, s,
                               cfg.head_dim, torch.bfloat16)
        kw = dict(window=cfg.sliding_window)
        window = (f" window {cfg.sliding_window}" if cfg.sliding_window
                  else "")
        err = check_close(
            f"flash prefill shape q {tuple(q.shape)} kv {tuple(k.shape)} "
            f"bf16{window}", flash_attention(q, k, v, **kw).float(),
            flash_attention_plain(q, k, v, **kw).float(),
            FLASH_TOL["bfloat16"])
        out[(b, s)] = {"qkv": (q, k, v), "window": cfg.sliding_window,
                       "errs": errs + [err]}

    # (b) the prefill steps at full width, bf16
    bundle = registry.build(cfg, device=dev)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    t0 = time.perf_counter()
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    phase(f"  {cfg.name} at {cfg.n_layers} layers: {cfg.num_params():.0f} "
          f"parameters built on the card from a seeded generator in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for i, shape in enumerate(prefills):
        got = prefill_check(cfg, bundle, plain, model, shape, sites,
                            seed=1 + i)
        out[shape]["launches"] = got["launches"]
        out[shape]["errs"] += got["errs"]
        out[shape]["wall"], out[shape]["floor"] = got["wall"], got["floor"]
        del got
    if resident is not None:
        out["resident"] = resident(cfg, bundle, model, out)
        torch.cuda.empty_cache()
    if not engine:
        del model, bundle, plain
        torch.cuda.empty_cache()
        phase(f"  {label}: {time.perf_counter() - t6:.1f} s")
        return out

    # (c) the engine at full width, bf16
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
          f"{weights / card_peaks()[0] * 1e3:.2f}"
          " ms")
    del eng, model, bundle, plain
    torch.cuda.empty_cache()

    # (d) greedy consistency at full width and reduced depth, f32: two
    # slots at one position, then a third request in a re-used slot
    f32 = dataclasses.replace(cfg, n_layers=f32_layers, dtype="float32",
                              **(f32_changes or {}))
    bundle = registry.build(f32, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(2))
    prompts = [rng.integers(1, cfg.vocab, 6).tolist() for _ in range(3)]
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
    extra = (f", capacity factor {f32.moe.capacity_factor}" if f32.moe
             else "")
    phase(f"  f32 {f32_layers}-layer engine{extra}, 2 slots at one "
          f"position and a re-used slot: {done} == argmax of the "
          f"kernel-run forward")
    toks = torch.tensor([p + done[rid] for rid, p in enumerate(prompts)],
                        device=dev)
    n = toks.shape[1]
    full = bundle.forward(model, {"tokens": toks})
    cache = bundle.cache_init(len(prompts), n)
    steps = []
    for t in range(n):
        lg, cache = bundle.decode(model, toks[:, t:t + 1], cache, t)
        steps.append(lg[:, 0])
    check_close(f"f32 decode logits vs forward logits over {n} positions",
                torch.stack(steps, dim=1), full, DECODE_TOL)
    del model, bundle, cache, full
    torch.cuda.empty_cache()
    phase(f"  {label}: {time.perf_counter() - t6:.1f} s")
    return out


def pipelined_prefill(cfg, bundle, model, out) -> dict:
    """Phase 6p: Qwen3-8B's layers as ``PIPE_STAGES`` stages of a stage
    mesh over ``["cuda:0"] * PIPE_STAGES``, ``PIPE_MICRO`` microbatches of
    1 x 2048 (``parallel/pipeline.py``): the hidden states after the last
    stage bitwise equal to the layers run on each microbatch in turn (the
    same launches on the same shapes), one flash launch per layer and
    microbatch and none on an idle (stage, tick), the wall beside the
    sequential run's and the 4x2048 prefill's, and the hand-off bytes per
    tick. Then the kernel at the new B 1 launch shape against its plain
    version. Returns phase 5's flash row."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import (
        pipeline_utilization,
        pipelined_forward,
        stack_stage_params,
    )

    t0 = time.perf_counter()
    n_st, n_mb = PIPE_STAGES, PIPE_MICRO
    s = PREFILL[1]
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(1, cfg.vocab, (n_mb, 1, s), generator=g,
                           device=dev)
    micro = model.embed[tokens]  # (M, 1, S, d)

    def stage_fn(layers, x):
        pos = torch.arange(x.shape[1], device=x.device)[None]
        for layer in layers:
            x = layer(x, cfg, pos)
        return x

    mesh = make_mesh((n_st,), ("stage",), [dev] * n_st)
    run = pipelined_forward(mesh, stage_fn)
    stages = stack_stage_params(model.layers, n_st)
    with torch.no_grad():
        run(stages, micro[:, :, :128])  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = torch.stack([stage_fn(model.layers, x) for x in micro])
        torch.cuda.synchronize()
        seq_wall = time.perf_counter() - t1
        flash_attention.launches = 0
        t1 = time.perf_counter()
        got = run(stages, micro)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = flash_attention.launches
    last = run.last
    phase(f"phase 6p: {cfg.name}'s {cfg.n_layers} layers in {n_st} stages "
          f"of {cfg.n_layers // n_st} over {mesh}, {n_mb} microbatches of "
          f"1x{s}: {last['ticks']} ticks, {last['stage_calls']} stage calls "
          f"(none on an idle tick), utilization pipeline_utilization("
          f"{n_mb}, {n_st}) = {pipeline_utilization(n_mb, n_st):.4f}")
    phase(f"  launches on the pipelined path: {{'flash_attention': "
          f"{launches}}}")
    if launches != cfg.n_layers * n_mb or last["stage_calls"] != n_st * n_mb:
        fail(f"phase 6p: {launches} flash launches and "
             f"{last['stage_calls']} stage calls, expected "
             f"{cfg.n_layers * n_mb} and {n_st * n_mb}")
    check_equal(f"pipelined {n_st} stages x {n_mb} microbatches vs the "
                "layers on each microbatch in turn", got, want)
    phase(f"  wall: pipelined {wall * 1e3:.1f} ms, the layers on each "
          f"microbatch in turn {seq_wall * 1e3:.1f} ms (one card runs the "
          f"stages one after another), the {PREFILL[0]}x{s} prefill "
          f"{out[PREFILL]['wall'] * 1e3:.1f} ms (with the head); hand-off "
          f"bytes per tick {last['handoff_bytes']} "
          f"({micro[0].numel() * micro.element_size()} a microbatch)")
    del got, want, micro
    q, k, v = flash_inputs(g, 1, cfg.n_heads, cfg.n_kv_heads, s, s,
                           cfg.head_dim, torch.bfloat16)
    err = check_close(
        f"flash pipelined stage shape q {tuple(q.shape)} kv "
        f"{tuple(k.shape)} bf16", flash_attention(q, k, v).float(),
        flash_attention_plain(q, k, v).float(), FLASH_TOL["bfloat16"])
    phase(f"  phase 6p: {time.perf_counter() - t0:.1f} s")
    return {"qkv": (q, k, v), "window": 0, "launches": launches,
            "errs": [err]}


def expert_parallel_prefill(cfg, bundle, model, out) -> dict:
    """Phase 6e: Mixtral's 4x2048 prefill (phase 6m's tokens) under the
    hints ``launch/dryrun.py`` passes, ``ep="model", ep_size=4,
    dp=("data",), dp_size=2, a2a=mesh`` on a (data 2, model 4) mesh over
    ``["cuda:0"] * 8``: every MoE layer through ``moe_ep_apply``'s two
    all-to-alls. Against the same prefill through the two-stage dispatch
    at ``dp_size`` 8 (the same per-rank capacity): the first MoE layer's
    drops per rank equal to its drops per block, the logits by phase 6m's
    floor rule, 16 flash launches; the all-to-all bytes per layer against
    ``tokens_loc · top_k · d · 2 B``. Then 2 layers in f32 at the no-drop
    capacity E/k on 1x2048, within ``EP_F32_REL_L2``. Returns the
    launch count."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.parallel.hints import sharding_hints

    t0 = time.perf_counter()
    dev = "cuda"
    dp, ep = EP_MESH
    mesh = make_mesh(EP_MESH, ("data", "model"), [dev] * (dp * ep))
    ep_hints = dict(ep="model", ep_size=ep, dp=("data",), dp_size=dp,
                    a2a=mesh, fsdp=None)
    b, s = PREFILL
    tokens = torch.randint(1, cfg.vocab, PREFILL, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": tokens}
    m = cfg.moe
    runs = {}
    for name, hints in (("expert-parallel", ep_hints),
                        ("two-stage", dict(dp_size=dp * ep))):
        sink = []
        with sharding_hints(**hints):
            bundle.forward(model, {"tokens": tokens[:, :128]})  # warm-up
            torch.cuda.synchronize()
            n0 = flash_attention.launches
            t1 = time.perf_counter()
            with drops_recorded(sink):
                logits = bundle.forward(model, batch)
            torch.cuda.synchronize()
            runs[name] = (logits, sink, time.perf_counter() - t1,
                          flash_attention.launches - n0)
    (ep_logits, ep_sink, ep_wall, ep_launches) = runs["expert-parallel"]
    (ts_logits, ts_sink, ts_wall, _) = runs["two-stage"]
    n_loc, cap = ep_sink[0]["n_loc"], ep_sink[0]["cap"]
    phase(f"phase 6e: {cfg.name} expert-parallel prefill {b}x{s} over "
          f"{mesh}, hints {dict(ep_hints, a2a='mesh')}: {len(ep_sink)} MoE "
          f"layers, n_loc {n_loc} tokens a rank, cap {cap}")
    phase(f"  launches on the expert-parallel path: {{'flash_attention': "
          f"{ep_launches}}}")
    if ep_launches != cfg.n_layers or len(ep_sink) != cfg.n_layers:
        fail(f"phase 6e: {ep_launches} flash launches, {len(ep_sink)} "
             f"all-to-all layers, expected {cfg.n_layers}")
    least = b * s * m.top_k * cfg.d_model * model.embed.element_size()
    sent, cross = ep_sink[0]["a2a_bytes"], ep_sink[0]["a2a_cross_bytes"]
    phase(f"  all-to-all bytes a layer (every layer alike: "
          f"{all(x['a2a_bytes'] == sent for x in ep_sink)}): out {sent[0]}, "
          f"back {sent[1]} (of them between distinct ranks {cross[0]}, "
          f"{cross[1]}), against tokens_loc x top_k x d x 2 B over the "
          f"{dp * ep} ranks = {least} each way (capacity factor "
          f"{m.capacity_factor})")
    ep_drops = [x["dropped"].tolist() for x in ep_sink]
    ts_drops = [x["dropped"].tolist() for x in ts_sink]
    phase(f"  dropped assignments per rank, first MoE layer: expert-parallel"
          f" {ep_drops[0]}, two-stage per block {ts_drops[0]}; all layers: "
          f"{sum(map(sum, ep_drops))} and {sum(map(sum, ts_drops))} of "
          f"{len(ep_sink) * b * s * m.top_k}")
    if ep_drops[0] != ts_drops[0]:
        fail(f"phase 6e: first MoE layer's drops {ep_drops[0]} != the "
             f"two-stage dispatch's {ts_drops[0]}")
    rel = rel_l2(ep_logits, ts_logits)
    floor = out[PREFILL]["floor"]
    limit = max(PREFILL_REL_L2, FLOOR_FACTOR * floor)
    phase(f"  logits, expert-parallel vs two-stage, every position: rel L2 "
          f"{rel:.3e} (<= {limit:.3e}: the larger of {PREFILL_REL_L2} and "
          f"{FLOOR_FACTOR} x phase 6m's rounding floor {floor:.3e}), max "
          f"abs err {max_err(ep_logits, ts_logits):.3e}; wall "
          f"{ep_wall * 1e3:.1f} ms vs {ts_wall * 1e3:.1f} ms")
    if not rel <= limit:
        fail(f"phase 6e logits: rel L2 {rel} > {limit}")
    del runs, ep_logits, ts_logits
    torch.cuda.empty_cache()

    # 2 layers in f32 at the no-drop capacity, one prompt
    f32 = dataclasses.replace(cfg, n_layers=2, dtype="float32", moe=(
        dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)))
    fb = registry.build(f32, device=dev)
    fm = fb.init(torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": tokens[:1]}
    with sharding_hints(**ep_hints):
        got = fb.forward(fm, batch)
    with sharding_hints(dp_size=dp * ep):
        want = fb.forward(fm, batch)
    rel = rel_l2(got, want)
    phase(f"  f32 2 layers, 1x{s}, capacity factor "
          f"{f32.moe.capacity_factor}: logits expert-parallel vs two-stage "
          f"rel L2 {rel:.3e} (<= {EP_F32_REL_L2}), max abs err "
          f"{max_err(got, want):.3e}")
    if not rel <= EP_F32_REL_L2:
        fail(f"phase 6e f32: rel L2 {rel} > {EP_F32_REL_L2}")
    del fm, fb, got, want
    phase(f"  phase 6e: {time.perf_counter() - t0:.1f} s")
    return {"launches": ep_launches}


def hybrid_f32_prefill() -> None:
    """Phase 6h(e): Zamba2-7B at full width and depth (81 layers, 13
    shared-block sites) in f32, the ``PREFILL`` batch through the kernel
    (the simple f32 instantiation at D 112) against the same model with
    plain attention: the two round the same f32 operations in another
    order, so the bf16 gate's rounding floor has no place here and the
    logits are held at ``ENC_DEC_REL_L2`` (docs/port.md §hybrid)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
    )
    from repro_torch.models import registry
    from repro_torch.models.zamba2 import schedule

    t0 = time.perf_counter()
    dev = "cuda"
    cfg = dataclasses.replace(get_arch("zamba2-7b"), dtype="float32")
    bundle = registry.build(cfg, device=dev)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    b, s = PREFILL
    batch = {"tokens": torch.randint(
        1, cfg.vocab, PREFILL, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() / 2**30
    flash_attention.launches = 0
    t1 = time.perf_counter()
    got = bundle.forward(model, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = flash_attention.launches
    if launches != schedule(cfg)[0]:
        fail(f"phase 6h f32: {launches} flash launches, expected "
             f"{schedule(cfg)[0]}")
    want = plain.forward(model, batch)
    rel = rel_l2(got, want)
    phase(f"  f32 {cfg.n_layers} layers ({weights:.2f} GiB of weights), "
          f"prefill {b}x{s} through the kernel ({launches} launches, "
          f"{wall * 1e3:.1f} ms), logits vs plain attention, every "
          f"position: rel L2 {rel:.3e} (<= {ENC_DEC_REL_L2}), max abs err "
          f"{max_err(got, want):.3e}, argmax agrees at "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{b * s}")
    if not torch.isfinite(got).all() or not rel <= ENC_DEC_REL_L2:
        fail(f"phase 6h f32 prefill vs plain attention: rel L2 {rel}")
    del model, bundle, plain, got, want
    torch.cuda.empty_cache()
    phase(f"  phase 6h f32: {time.perf_counter() - t0:.1f} s")


def moe_serving():
    """Phases 6m (Mixtral-8x7B) and 6k (Kimi K2), the MoE family at full
    width and cut depth, bf16, seeded weights built on the card: the
    prefills (Mixtral's 4x2048 and 1x8192, where its window of 4096
    binds; Kimi's 4x2048 at D 112 with GQA 8), each flash site held to
    its plain version on its own q, k, v; Mixtral's engine and its f32
    greedy check at 2 layers with the no-drop capacity factor E/k
    (docs/port.md §moe); phase 6e on Mixtral's resident model. Mixtral is
    freed before Kimi is built."""
    import dataclasses

    from repro_torch.configs import get_arch

    mixtral = dataclasses.replace(get_arch("mixtral-8x7b"),
                                  n_layers=MIXTRAL_LAYERS)
    moe = mixtral.moe
    mix = lm_serving(
        mixtral, "phase 6m", f32_layers=2, prefills=(PREFILL, LONG_PREFILL),
        matrix=False, f32_changes={"moe": dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k)},
        resident=expert_parallel_prefill)
    kimi = lm_serving(
        dataclasses.replace(get_arch("kimi-k2-1t-a32b"),
                            n_layers=KIMI_LAYERS),
        "phase 6k", f32_layers=0, matrix=False, engine=False)
    return mix, kimi


def whisper_serving() -> dict:
    """Phase 6w, whisper-medium at full width and depth (24 + 24 layers, d
    1024, 16 heads at D 64), 8 clips of 1500 frames and 375 tokens:
    (a) the kernel against its plain version at D 64 (the reference's
    matrix) and at the path's four launch shapes; (b) ``forward_enc_dec``
    in bf16 (72 launches, each site and the logits held as in
    :func:`prefill_check`); (d) the times of ``encode``,
    ``prime_cross_cache`` and a bf16 decode step; then, the bf16 model
    freed, (b) in f32 against the plain-attention twin and (c) 32
    teacher-forced f32 decode steps against the forward. Returns the
    phase-5 rows' numbers by launch shape (docs/port.md §encdec)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm

    t6 = time.perf_counter()
    cfg = get_arch("whisper-medium")
    dev = "cuda"
    b, t = WHISPER
    n = t // 4
    phase(f"phase 6w: encoder-decoder serving, {cfg.name} ({cfg.family}), "
          f"{b} clips x {t} frames, {n} tokens")
    g = torch.Generator(device=dev).manual_seed(0)

    # (a) the kernel against its plain version: the matrix at D 64, then
    # each launch shape of the path, through the dispatcher
    errs = flash_vs_plain(cfg.head_dim, g)
    shapes = {"encoder self": (t, t, False), "cross": (n, t, False),
              "decoder self": (n, n, True), "decode cross": (1, t, False)}
    out = {}
    for name, (sq, sk, causal) in shapes.items():
        qkv = flash_inputs(g, b, cfg.n_heads, cfg.n_kv_heads, sq, sk,
                           cfg.head_dim, torch.bfloat16)
        err = check_close(
            f"flash whisper {name} q {tuple(qkv[0].shape)} kv "
            f"{tuple(qkv[1].shape)} bf16{'' if causal else ' non-causal'}",
            attention(*qkv, causal=causal).float(),
            flash_attention_plain(*qkv, causal=causal).float(),
            FLASH_TOL["bfloat16"])
        out[name] = {"qkv": qkv, "window": 0, "causal": causal,
                     "errs": errs + [err]}

    # (b) the prefill at full width and depth, bf16
    bundle = registry.build(cfg, device=dev)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    t0 = time.perf_counter()
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    phase(f"  {cfg.name} at {cfg.n_layers} + {cfg.n_layers} layers: "
          f"{cfg.num_params():.0f} parameters built on the card from a "
          f"seeded generator in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    got = prefill_check(cfg, bundle, plain, model, WHISPER,
                        3 * cfg.n_layers, seed=1)
    want = {(t, t, False): cfg.n_layers, (n, t, False): cfg.n_layers,
            (n, n, True): cfg.n_layers}
    if got["by_shape"] != want:
        fail(f"whisper prefill launches by shape {got['by_shape']} != "
             f"{want}")
    for name, (sq, sk, causal) in shapes.items():
        if name != "decode cross":
            out[name]["launches"] = got["by_shape"][(sq, sk, causal)]
            out[name]["errs"] += got["errs"]
    frames, tokens = got["batch"]["frames"], got["batch"]["tokens"]
    del got

    # (d) encode, prime_cross_cache and one bf16 decode step
    def wall_of(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps, res

    enc_s, enc = wall_of(lambda: tfm.encode(model, frames))
    cache = bundle.cache_init(b, n)
    prime_s, cache = wall_of(lambda: tfm.prime_cross_cache(model, cache,
                                                           enc))
    tok = tokens[:, :1]
    bundle.decode(model, tok, cache, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(10):
        bundle.decode(model, tokens[:, i:i + 1], cache, i)
    enqueue = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 10
    out["decode cross"]["launches"] = flash_attention.launches
    phase(f"  launches on the {cfg.name} decode path (10 steps, {b} clips, "
          f"cross K/V over {t} frames): {{'flash_attention': "
          f"{flash_attention.launches}}}")
    if flash_attention.launches != 10 * cfg.n_layers:
        fail(f"whisper decode: {flash_attention.launches} launches in 10 "
             f"steps, expected {10 * cfg.n_layers}")
    phase(f"  encode {b}x{t}: {enc_s * 1e3:.1f} ms ({b * t / enc_s:.0f} "
          f"frames/s); prime_cross_cache: {prime_s * 1e3:.2f} ms; one "
          f"decode step ({b} clips): {step * 1e3:.2f} ms, host enqueue "
          f"{enqueue * 1e3:.2f} ms; peak memory over the decode steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, bundle, plain, cache, enc
    torch.cuda.empty_cache()

    # (b) and (c) in f32 at full depth: the forward against the
    # plain-attention twin, and teacher-forced decode against the forward
    f32 = dataclasses.replace(cfg, dtype="float32")
    bundle = registry.build(f32, device=dev)
    plain = registry.build(f32, device=dev, use_kernel=False)
    model = bundle.init(torch.Generator(device=dev).manual_seed(2))
    frames = frames.float()
    flash_attention.launches = 0
    full = bundle.forward(model, {"frames": frames, "tokens": tokens})
    if flash_attention.launches != 3 * cfg.n_layers:
        fail(f"whisper f32 forward: {flash_attention.launches} launches")
    ref = plain.forward(model, {"frames": frames, "tokens": tokens})
    rel = rel_l2(full, ref)
    phase(f"  f32 {cfg.n_layers} + {cfg.n_layers} layers, logits vs plain "
          f"attention, every position: rel L2 {rel:.3e} (<= "
          f"{ENC_DEC_REL_L2}), max abs err {max_err(full, ref):.3e}")
    if not rel <= ENC_DEC_REL_L2:
        fail(f"whisper f32 forward vs plain: rel L2 {rel}")
    del ref
    cache = tfm.prime_cross_cache(
        model, bundle.cache_init(b, WHISPER_DECODE_STEPS),
        tfm.encode(model, frames))
    flash_attention.launches = 0
    steps = []
    for i in range(WHISPER_DECODE_STEPS):
        lg, cache = bundle.decode(model, tokens[:, i:i + 1], cache, i)
        steps.append(lg[:, 0])
    steps = torch.stack(steps, dim=1)
    head = full[:, :WHISPER_DECODE_STEPS]
    rel = rel_l2(steps, head)
    agree = int((steps.argmax(-1) == head.argmax(-1)).sum())
    phase(f"  f32 {WHISPER_DECODE_STEPS} teacher-forced decode steps after "
          f"prime_cross_cache ({flash_attention.launches} launches at Sq 1) "
          f"vs the forward's rows: rel L2 {rel:.3e} (<= {ENC_DEC_REL_L2}), "
          f"argmax equal at {agree}/{steps.shape[0] * steps.shape[1]}")
    if (flash_attention.launches != WHISPER_DECODE_STEPS * cfg.n_layers
            or not rel <= ENC_DEC_REL_L2
            or agree != steps.shape[0] * steps.shape[1]):
        fail("whisper f32 decode vs forward")
    del model, bundle, plain, cache, full, steps, head
    torch.cuda.empty_cache()
    phase(f"  phase 6w: {time.perf_counter() - t6:.1f} s")
    return out


def vlm_serving():
    """Phase 6v, LLaVA-NeXT-34B at full width (d 7168, 56 : 8 heads at
    D 128) and the deepest depth of its 60 layers that fits beside
    ``VLM_HEADROOM``, bf16: (a) the kernel at the prefill's launch shape
    (GQA 7), (b) the prefill of 2,880 frontend embeds and 1,216 tokens
    through ``make_batch``, (c) the engine on text prompts, (d) 4 layers
    in f32 (docs/port.md §vlm). Returns phase 5's numbers."""
    from repro_torch.configs import get_arch

    cfg = depth_that_fits(get_arch("llava-next-34b"), "phase 6v",
                          VLM_HEADROOM)
    return lm_serving(cfg, "phase 6v", f32_layers=4,
                      prefills=(VLM_PREFILL,), matrix=False)


def depth_that_fits(cfg, label: str, headroom: int):
    """``cfg`` at the deepest depth of its layers whose bf16 weights fit
    in the card's free memory beside ``headroom`` bytes, the choice and
    any cut printed."""
    import dataclasses

    import torch

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    per_layer = 2 * cfg.layer_params()
    fixed = 2 * cfg.num_params() - cfg.n_layers * per_layer
    depth = min(cfg.n_layers, int((free - fixed - headroom) // per_layer))
    phase(f"{label}: {cfg.name} at {depth} of {cfg.n_layers} layers: "
          f"{free / 2**30:.2f} GiB free, the weights of all "
          f"{cfg.n_layers} {2 * cfg.num_params() / 2**30:.2f} GiB, "
          f"{headroom / 2**30:.0f} GiB kept for the prefill"
          + ("" if depth == cfg.n_layers else " (the depth is cut)"))
    return dataclasses.replace(cfg, n_layers=depth)


def dense_serving() -> dict:
    """Phase 6d, the dense configs that differ from Qwen3-8B, at full
    width in bf16, each at the deepest depth that fits (all of it:
    granite-34b's 88 layers, MQA 48:1 with GELU; nemotron-4-15b's 32,
    GQA 48:8, squared ReLU, 256,000 tokens; qwen2.5-32b's 64, GQA 40:8,
    qkv biases): phase 6's four steps through :func:`lm_serving` at the
    4x2048 prefill, (d) at 2 layers in f32. Each model is freed before
    the next is built (docs/port.md §dense-card). Returns phase 5's
    numbers by config."""
    from repro_torch.configs import get_arch

    out = {}
    b, s = PREFILL
    for name in DENSE_SERVING:
        cfg = get_arch(name)
        logits = 3 * b * s * cfg.vocab * 2
        cfg = depth_that_fits(cfg, "phase 6d", DENSE_HEADROOM + logits)
        out[name] = lm_serving(cfg, "phase 6d", f32_layers=2, matrix=False)
    return out


def kernel_launches(fn) -> int:
    """The device activities (kernels, copies, fills) of one call of
    ``fn``, as ``torch.profiler`` records them on the card alone (the raw
    kineto events, not parsed into Python objects)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def ssm_serving() -> None:
    """Phase 6x, xLSTM-125m at full width and depth (12 blocks, sLSTM at
    5 and 11, d 768, 4 heads: mLSTM D 384), bf16, seeded weights: (a)
    the prefill 4x2048 at chunk 128 with its device activities per
    prefill, and each block kind alone; (b) the engine; (c) in f32 at full
    depth over ``SSM_CONSISTENCY`` tokens, each block's chunked apply
    against its step-by-step decode (``SSM_TOL``) and the whole model's
    decode against the chunked forward (``SSM_REL_L2``, argmax equal);
    (d) f32 engines at 6
    blocks (one sLSTM), ``max_batch`` 2 and 3, against the greedy forward
    (docs/port.md §ssm). No attention, so no flash launch."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from repro_torch.models import xlstm as xl
    from repro_torch.serve.engine import Request, ServeEngine

    t6 = time.perf_counter()
    cfg = get_arch("xlstm-125m")
    dev = "cuda"
    pattern = registry._xlstm_pattern(cfg)
    slstm = [i for i, k in enumerate(pattern) if k == "slstm"]
    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    phase(f"phase 6x: SSM serving, {cfg.name} ({cfg.family}) at "
          f"{cfg.n_layers} blocks (sLSTM at {slstm}), bf16: "
          f"{cfg.num_params():.0f} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    b, s = SSM_PREFILL
    tok = torch.randint(1, cfg.vocab, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    prefill = bundle.make_prefill_step()
    prefill(model, {"tokens": tok[:1, :256]})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nxt = prefill(model, {"tokens": tok})
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if nxt.shape != (b, cfg.vocab) or not torch.isfinite(nxt).all():
        fail(f"xlstm prefill logits: shape {tuple(nxt.shape)} or "
             "non-finite")
    t0 = time.perf_counter()
    n = kernel_launches(lambda: prefill(model, {"tokens": tok}))
    count_s = time.perf_counter() - t0
    phase(f"  prefill {b}x{s} (chunk {cfg.ssm.chunk}): {wall * 1e3:.1f} ms "
          f"(host enqueue {enqueue * 1e3:.1f} ms), {b * s / wall:.0f} "
          f"tokens/s, peak memory {peak:.2f} GiB (weights included); "
          f"{n} device activities (torch.profiler) per prefill (counted "
          f"in {count_s:.1f} s)")
    with torch.no_grad():
        x = model.embed[tok]
        for kind, i in (("mLSTM", 0), ("sLSTM", slstm[0])):
            fn = (xl.mlstm_block_apply if kind == "mLSTM"
                  else xl.slstm_block_apply)
            ms, _ = cuda_ms(lambda: fn(model.blocks[i], x, cfg), 2)
            host = enqueue_ms(lambda: fn(model.blocks[i], x, cfg), 2)
            phase(f"  one {kind} block alone on {b}x{s}: {ms:.2f} ms, "
                  f"host enqueue {host:.2f} ms")
        del x

    # (b) the engine at full width, bf16
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
        fail(f"xlstm engine completions malformed: "
             f"{[(c.rid, c.tokens) for c in done]}")
    phase(f"  engine: 8 requests x 16 tokens on 4 slots in "
          f"{wall * 1e3:.1f} ms, {8 * 16 / wall:.1f} decode tokens/s, "
          f"{eng.decode_calls} decode steps")
    one = torch.ones((4, 1), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        bundle.decode(model, one, eng.cache, 200 + i)
    enqueue = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 10
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    phase(f"  one decode step (4 slots): {step * 1e3:.2f} ms, host enqueue "
          f"{enqueue * 1e3:.2f} ms, weight-read bound "
          f"{weights / card_peaks()[0] * 1e3:.3f}"
          " ms")
    del eng, model, bundle
    torch.cuda.empty_cache()

    # (c) f32 at full depth: the chunked forward against the recurrence,
    # block by block and for the whole model
    f32 = dataclasses.replace(cfg, dtype="float32")
    bundle = registry.build(f32, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(2))
    n = SSM_CONSISTENCY
    toks = torch.randint(1, cfg.vocab, (2, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    t0 = time.perf_counter()
    errs = []
    with torch.no_grad():
        x = model.embed[toks]
        states = bundle.cache_init(2, n)
        for block, kind, st in zip(model.blocks, model.pattern, states):
            apply, step = ((xl.mlstm_block_apply, xl.mlstm_block_decode)
                           if kind == "mlstm" else
                           (xl.slstm_block_apply, xl.slstm_block_decode))
            y = apply(block, x, f32)
            ys = torch.cat([step(block, x[:, t:t + 1], f32, st)[0]
                            for t in range(n)], dim=1)
            errs.append(max_err(ys, y))
            if not torch.allclose(ys, y, **SSM_TOL):
                fail(f"f32 {kind} block {len(errs) - 1}: step-by-step decode "
                     f"vs chunked apply, max abs err {errs[-1]}")
            x = y
    phase(f"  f32, each of the {cfg.n_layers} blocks' chunked apply vs its "
          f"step-by-step decode over {n} tokens on the block's own input: "
          f"max abs err {max(errs):.3e} (rtol {SSM_TOL['rtol']}, atol "
          f"{SSM_TOL['atol']}, the reference's tolerance for the pair); "
          f"{time.perf_counter() - t0:.1f} s")
    full = bundle.forward(model, {"tokens": toks})
    cache = bundle.cache_init(2, n)
    rows = []
    for t in range(n):
        lg, cache = bundle.decode(model, toks[:, t:t + 1], cache, t)
        rows.append(lg[:, 0])
    got = torch.stack(rows, dim=1)
    rel = rel_l2(got, full)
    agree = int((got.argmax(-1) == full.argmax(-1)).sum())
    phase(f"  f32 {cfg.n_layers}-block xlstm_decode step by step vs the "
          f"chunked forward over {n} tokens: rel L2 {rel:.3e} (<= "
          f"{SSM_REL_L2}), max abs err {max_err(got, full):.3e}, argmax "
          f"equal at {agree}/{2 * n} positions")
    if not rel <= SSM_REL_L2 or agree != 2 * n:
        fail(f"f32 xlstm decode vs forward: rel L2 {rel}, argmax equal at "
             f"{agree}/{2 * n}")
    del model, bundle, cache, full, got, rows, x, y, ys, states
    torch.cuda.empty_cache()

    # (d) f32 engines at reduced depth against the greedy forward
    small = dataclasses.replace(f32, n_layers=6)
    bundle = registry.build(small, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(4))
    prompts = [rng.integers(1, cfg.vocab, 6).tolist() for _ in range(3)]
    for max_batch in (2, 3):
        eng = ServeEngine(bundle, model, max_batch=max_batch, max_seq=64)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=list(p), max_new_tokens=8))
        done = {c.rid: c.tokens for c in eng.run_until_drained()}
        for rid, p in enumerate(prompts):
            seq = list(p)
            for t in done[rid]:
                logits = bundle.forward(model, {"tokens": torch.tensor(
                    [seq], device=dev)})
                if t != int(logits[0, -1].argmax()):
                    fail(f"f32 xlstm engine (max_batch {max_batch}) request "
                         f"{rid}: token {t} != forward argmax after {seq}")
                seq.append(t)
        phase(f"  f32 6-block engine, max_batch {max_batch} (3 requests): "
              f"{done} == argmax of the greedy forward")
    del model, bundle, eng
    torch.cuda.empty_cache()
    phase(f"  phase 6x: {time.perf_counter() - t6:.1f} s")


def leaf_names(tree, prefix="") -> list:
    """The key path of every leaf of ``tree`` in ``tree_flatten``'s order
    (a dict's keys sorted, a list's indices)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree)
                for n in leaf_names(x, f"{prefix}{i}.")]
    return [prefix[:-1]]


def ssm_training() -> None:
    """Phase 11a: xLSTM-125m trained at full width and depth through the
    port's loop, bf16 parameters and f32 AdamW, ``TRAIN_SSM`` synthetic
    tokens a step, ``TRAIN_STEPS`` steps with a checkpoint every
    ``TRAIN_CKPT_EVERY`` and faults after ``TRAIN_FAULTS``, beside the
    same steps unbroken: two restarts, every loss finite, the losses
    after the last restore against the unbroken run's
    (``TRAIN_LOSS_RTOL``), the newest checkpoint restored bitwise, with
    step ms, tokens/s, peak memory and the seconds of a save and a
    restore (docs/port.md §train)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import param_tree
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import LoopConfig, run_with_restarts
    from repro_torch.train.optimizer import AdamWConfig, init_state

    t11 = time.perf_counter()
    cfg = get_arch("xlstm-125m")
    b, s = TRAIN_SSM
    phase(f"phase 11a: training {cfg.name} at full width and depth "
          f"({cfg.num_params():.0f} parameters, bf16; AdamW moments "
          f"{cfg.opt_state_dtype}), {b}x{s} synthetic tokens a step, "
          f"{TRAIN_STEPS} steps, a checkpoint every {TRAIN_CKPT_EVERY}")
    bundle = registry.build(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                          state_dtype=cfg.opt_state_dtype)
    data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0)
    tmp = tempfile.mkdtemp(prefix="phase11-")
    runs = {}
    try:
        for name, faults in (("restarted", TRAIN_FAULTS), ("unbroken", ())):
            model = bundle.init(torch.Generator(device="cuda").manual_seed(0))
            opt = init_state(opt_cfg, param_tree(model))
            loop = LoopConfig(total_steps=TRAIN_STEPS,
                              ckpt_dir=os.path.join(tmp, name),
                              ckpt_every=TRAIN_CKPT_EVERY,
                              log_every=TRAIN_STEPS, fail_at_steps=faults)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, opt, st = run_with_restarts(
                loop, data, bundle.make_train_step(opt_cfg), model, opt,
                log=lambda m, name=name: phase(f"  {name}: {m}"))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not all(math.isfinite(x) for x in st.losses):
                fail(f"phase 11a {name}: a loss is not finite: {st.losses}")
            if st.step != TRAIN_STEPS or st.restarts != len(faults):
                fail(f"phase 11a {name}: {st.step} steps, {st.restarts} "
                     f"restarts")
            times = sorted(st.step_times[1:])
            med = times[len(times) // 2]
            phase(f"  {name}: {st.step} steps, {st.restarts} restarts, "
                  f"{st.straggler_events} stragglers in {wall:.1f} s; "
                  f"step {med * 1e3:.1f} ms (median after the first; first "
                  f"{st.step_times[0] * 1e3:.1f} ms), {b * s / med:.0f} "
                  f"tokens/s, peak memory {peak:.2f} GiB; losses "
                  + ", ".join(f"{x:.4f}" for x in st.losses))
            runs[name] = (model, opt, st, loop.ckpt_dir)
        model, opt, st, ck = runs["restarted"]
        want = runs["unbroken"][2].losses[-len(st.losses):]
        rel = max(abs(x - y) / abs(y) for x, y in zip(st.losses, want))
        phase(f"  restarted vs unbroken, the {len(st.losses)} losses after "
              f"the last restore: max rel diff {rel:.3e} (<= "
              f"{TRAIN_LOSS_RTOL})")
        if not rel <= TRAIN_LOSS_RTOL:
            fail(f"phase 11a: restarted losses {st.losses} vs unbroken "
                 f"{want}")
        tree = {"params": param_tree(model), "opt": opt}
        leaves = ckpt.tree_flatten(tree)[0]
        sums = [l2_sums(x, y) for x, y in zip(
            ckpt.tree_flatten(tree["params"])[0],
            ckpt.tree_flatten(param_tree(runs["unbroken"][0]))[0])]
        drift = math.sqrt(sum(x for x, _ in sums) / sum(y for _, y in sums))
        phase(f"  restarted vs unbroken parameters after {TRAIN_STEPS} "
              f"steps: rel L2 {drift:.3e} (not gated)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, got, _ = ckpt.restore_latest(ck, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = [i for i, (a, x) in enumerate(zip(ckpt.tree_flatten(got)[0],
                                                leaves))
               if not torch.equal(a, x)]
        if step != TRAIN_STEPS or bad:
            fail(f"phase 11a: restored step {step}, leaves {bad} differ "
                 "from the saved")
        t0 = time.perf_counter()
        ckpt.save(os.path.join(tmp, "timed"), TRAIN_STEPS, tree)
        save_s = time.perf_counter() - t0
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        phase(f"  the step-{step} checkpoint restored vs the saved "
              f"parameters and moments ({len(leaves)} leaves, "
              f"{nbytes / 2**30:.2f} GiB): bitwise equal; a save "
              f"{save_s:.2f} s, the restore {restore_s:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del runs, model, opt, tree, got, leaves
    torch.cuda.empty_cache()
    phase(f"  phase 11a: {time.perf_counter() - t11:.1f} s")


def dp_compression() -> None:
    """Phase 11c: xLSTM-125m at full width and depth, its 8x2048 batch
    split over ``DP_RANKS`` data ranks of ``["cuda:0"] * DP_RANKS``
    (``sharding.shard``, views), each rank's loss gradients, and
    ``compressed_psum`` over them (``parallel/compression.py``): ``none``
    bitwise equal to the f32 mean ``make_train_step(num_microbatches=2)``
    forms from the same gradients (``0 + g0 + g1`` in f32, then ``/ 2``),
    and that step's loss the mean of the ranks' losses; ``int8_ef``
    within ``sum_r scale_r / (2R)`` of that mean, each residual ``x -
    deq`` exactly; ``topk_ef`` with ``deq + residual == x`` bitwise; the
    payload of each scheme against the bf16 baseline."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import param_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.registry import _grads
    from repro_torch.parallel.compression import (
        CompressionConfig,
        compress_int8,
        compress_topk,
        compressed_psum,
        init_residuals,
        payload_bytes,
    )
    from repro_torch.parallel.sharding import P, shard
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import DataConfig, SyntheticTokens
    from repro_torch.train.optimizer import AdamWConfig, init_state

    t0 = time.perf_counter()
    cfg = get_arch("xlstm-125m")
    b, s = TRAIN_SSM
    dev = "cuda"
    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    source = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=s,
                                        global_batch=b, seed=0))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in source.batch_at(0).items()}
    mesh = make_mesh((DP_RANKS,), ("data",), [dev] * DP_RANKS)
    halves = {k: shard(v, P("data", None), mesh) for k, v in batch.items()}
    params = param_tree(model)
    leaves, treedef = ckpt.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    losses, rank_grads = [], []
    for r in range(DP_RANKS):
        loss = bundle.loss(model, {k: v[r] for k, v in halves.items()})
        rank_grads.append(ckpt.tree_unflatten(treedef, _grads(loss, leaves)))
        losses.append(loss.detach())
    phase(f"phase 11c: {cfg.name} data-parallel gradients over {mesh}: "
          f"{DP_RANKS} ranks of {b // DP_RANKS}x{s}, {len(leaves)} leaves, "
          f"losses {[f'{float(x):.6f}' for x in losses]}")
    flat = [ckpt.tree_flatten(g)[0] for g in rank_grads]
    res = [init_residuals(g) for g in rank_grads]
    zeros = [ckpt.tree_flatten(x)[0] for x in res]
    # the f32 mean of make_train_step(num_microbatches=2), on these grads
    want = []
    for j, p in enumerate(leaves):
        acc = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        for r in range(DP_RANKS):
            acc.add_(flat[r][j])
        want.append(acc.div_(DP_RANKS))
    out = {}
    for scheme in ("none", "int8_ef", "topk_ef"):
        cc = CompressionConfig(scheme, topk_frac=TOPK_FRAC)
        compressed_psum(rank_grads, res, cc)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mean, new_r = compressed_psum(rank_grads, res, cc)
        torch.cuda.synchronize()
        out[scheme] = (ckpt.tree_flatten(mean)[0],
                       [ckpt.tree_flatten(x)[0] for x in new_r],
                       time.perf_counter() - t1)
    got = out["none"][0]
    bad = [j for j in range(len(leaves)) if not torch.equal(got[j], want[j])]
    phase(f"  none vs make_train_step's f32 mean of the same gradients: "
          f"{'bitwise equal' if not bad else f'leaves {bad} differ'}")
    if bad:
        fail(f"phase 11c none: leaves {bad} != the microbatched mean")
    worst, resid_ok = 0.0, True
    mean8, res8, _ = out["int8_ef"]
    for j in range(len(leaves)):
        scales = []
        for r in range(DP_RANKS):
            (q, scale), deq, _ = compress_int8(flat[r][j], zeros[r][j])
            scales.append(float(scale))
            resid_ok &= torch.equal(res8[r][j],
                                    flat[r][j].float() - deq)
        bound = sum(scales) / (2 * DP_RANKS)
        err = float((mean8[j] - want[j]).abs().max())
        worst = max(worst, err / bound)
        if not err <= bound:
            fail(f"phase 11c int8_ef leaf {j}: max abs err {err} > "
                 f"sum(scale) / 2R = {bound}")
    phase(f"  int8_ef: every element within sum_r scale_r / (2R) of the "
          f"mean (worst leaf at {worst:.3f} of its bound); each residual == "
          f"x - deq: {resid_ok}")
    if not resid_ok:
        fail("phase 11c int8_ef: a residual != x - deq")
    meank, resk, _ = out["topk_ef"]
    topk_ok = True
    for j in range(len(leaves)):
        for r in range(DP_RANKS):
            x = flat[r][j].float()
            _, deq, nr = compress_topk(flat[r][j], zeros[r][j], TOPK_FRAC)
            topk_ok &= torch.equal(nr, resk[r][j]) and torch.equal(
                deq + resk[r][j], x)
    phase(f"  topk_ef (frac {TOPK_FRAC}): deq + residual == x bitwise on "
          f"every leaf and rank: {topk_ok}")
    if not topk_ok:
        fail("phase 11c topk_ef: deq + residual != x")
    base = payload_bytes(params, CompressionConfig("none"))
    phase("  payload bytes a step: " + ", ".join(
        f"{scheme} {payload_bytes(params, CompressionConfig(scheme, TOPK_FRAC))}"
        f" ({payload_bytes(params, CompressionConfig(scheme, TOPK_FRAC)) / base:.4f}"
        f" of the bf16 baseline; all-reduce {out[scheme][2] * 1e3:.1f} ms)"
        for scheme in ("none", "int8_ef", "topk_ef")))
    # one make_train_step(num_microbatches=2) on the whole batch
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    step = bundle.make_train_step(opt_cfg, num_microbatches=DP_RANKS,
                                  dp_axes=("data",))
    _, _, metrics = step(model, init_state(opt_cfg, params), batch)
    mean_loss = float(sum(x.float() for x in losses)) / DP_RANKS
    rel = abs(float(metrics["loss"]) - mean_loss) / abs(mean_loss)
    phase(f"  make_train_step(num_microbatches={DP_RANKS}) loss "
          f"{float(metrics['loss']):.7f} vs the ranks' mean {mean_loss:.7f}: "
          f"rel diff {rel:.2e} (<= 1e-6)")
    if not rel <= 1e-6:
        fail(f"phase 11c: step loss {float(metrics['loss'])} vs {mean_loss}")
    del model, rank_grads, flat, res, zeros, out, want, leaves, params, metrics
    torch.cuda.empty_cache()
    phase(f"  phase 11c: {time.perf_counter() - t0:.1f} s")


def train_check(cfg, bundle, plain, model, batches, rate, label: str, *,
                sites: int, keyed: bool = False) -> dict:
    """Step 0's gradients of ``model`` on ``batches(0)`` through the flash
    kernel (``FlashAttentionFn``: ``sites`` launches forward and, under
    the default remat ``"none"``, which runs each site's forward again in
    the backward, as many there; the Function's own backward launches the
    backward kernel once a site on the Hopper path, bf16 at a pair of
    ``HOPPER_DIMS``) against plain attention's, every leaf of the reference's
    tree within the larger of ``GRAD_REL_L2`` and ``FLOOR_FACTOR`` x its
    rounding floor (the plain twin's gradient with every attention output
    moved at the rounding level: :func:`rounding_noise` with remat off,
    or with ``keyed`` :func:`keyed_noise` under the default remat, whose
    recompute moves each output as its forward did); an MoE model's
    experts held to the kernel run's (:func:`routing_fixed`). Then
    ``DENSE_STEPS`` steps of ``make_train_step`` on ``batches(i)``, the
    launches of each counted (the backward kernel's too), by launch shape
    too, and the fused AdamW
    pass's launches of each held to one norm launch a table of parts, the
    finalize and one update launch a table (the counters set to 0 first).
    ``rate(seconds)`` words a step's throughput. Returns the state for
    further steps and phase 5's numbers."""
    import torch

    from repro_torch.interop import Stacked, param_tree
    from repro_torch.kernels.adamw.adamw import (
        MAX_PARTS,
        adamw_step,
        adamw_sumsq,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        HOPPER_DIMS,
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.parallel.hints import sharding_hints
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, init_state

    # bf16 at a pair of HOPPER_DIMS takes the Hopper path: one backward
    # launch a site
    bwd_sites = sites if (cfg.dtype == "bfloat16" and (
        cfg.head_dim, cfg.v_head_dim or cfg.head_dim) in HOPPER_DIMS) else 0
    tree = param_tree(model)
    leaves = ckpt.tree_flatten(tree)[0]
    names = leaf_names(tree)
    groups = [x.parts if isinstance(x, Stacked) else [x] for x in leaves]
    parts = [p for g in groups for p in g]
    for p in parts:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batches(0).items()}
    routes, flips = {}, {}

    def grads(which, noise=None, run="kernel"):
        # the generator's noise run keeps its activations (remat off): a
        # recompute would draw other noise than the forward's
        ctx = contextlib.ExitStack()
        if noise is not None:
            ctx.enter_context(attention_through(
                (keyed_noise if keyed else rounding_noise)(noise)))
            if not keyed:
                ctx.enter_context(sharding_hints(remat="off"))
        if cfg.moe:
            ctx.enter_context(routing_fixed(routes, flips.setdefault(run,
                                                                      [])))
        n0, nb = flash_attention.launches, flash_attention_bwd.launches
        with ctx:
            loss = which.loss(model, batch)
            n1 = flash_attention.launches
            gs = torch.autograd.grad(loss, parts)
        return float(loss.detach()), gs, (
            n1 - n0, flash_attention.launches - n1,
            flash_attention_bwd.launches - nb)

    def per_leaf(gs, ref):
        """The relative L2 of ``gs`` against ``ref`` per leaf of the
        reference's tree (a stacked leaf's parts together)."""
        out, i = [], 0
        for g in groups:
            sums = [l2_sums(a, r) for a, r in zip(gs[i:i + len(g)],
                                                  ref[i:i + len(g)])]
            num, den = sum(x for x, _ in sums), sum(y for _, y in sums)
            out.append(math.sqrt(num / den) if den else 0.0)
            i += len(g)
        return out

    loss_k, gk, (fwd, bwd, kbwd) = grads(bundle)
    phase(f"  step 0 through the kernel: loss {loss_k:.4f}, flash launches "
          f"{{'forward': {fwd}, 'backward': {bwd}}}, backward kernel "
          f"launches {kbwd}")
    if fwd != sites or bwd != sites or kbwd != bwd_sites:
        fail(f"{label}: flash launched {fwd} times forward and {bwd} "
             f"backward (expected {sites} each: remat recomputes every "
             f"site), the backward kernel {kbwd} times (expected "
             f"{bwd_sites})")
    loss_p, gp, _ = grads(plain, run="plain")
    rels = per_leaf(gk, gp)
    del gk
    _, gn, _ = grads(plain, NOISE_SEEDS[0], run="noise")
    floors = per_leaf(gn, gp)
    del gn, gp
    limits = [max(GRAD_REL_L2, FLOOR_FACTOR * f) for f in floors]
    worst = max(range(len(rels)), key=lambda i: rels[i] / limits[i])
    phase(f"  step 0 gradients, kernel vs plain attention, {len(rels)} "
          f"leaves of the reference's tree: worst {names[worst]} rel L2 "
          f"{rels[worst]:.3e} (<= {limits[worst]:.3e}: the larger of "
          f"{GRAD_REL_L2} and {FLOOR_FACTOR} x its rounding floor "
          f"{floors[worst]:.3e}); largest rel L2 {max(rels):.3e}, largest "
          f"floor {max(floors):.3e}; loss {loss_k:.6f} vs plain "
          f"{loss_p:.6f}")
    if cfg.moe:
        n = sum(x.numel() for x in routes.values())
        phase(f"  top-k experts held to the kernel run's in {len(routes)} "
              f"MoE layers ({n} assignments a pass, recomputes included): "
              "assignments a run's own top-k would have changed: "
              + ", ".join(f"{run} {sum(f)}" for run, f in flips.items()))
    bad = [f"{names[i]}: {rels[i]:.3e} > {limits[i]:.3e}"
           for i in range(len(rels)) if not rels[i] <= limits[i]]
    if bad:
        fail(f"{label} gradients vs plain attention: " + "; ".join(bad))
    torch.cuda.empty_cache()

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=DENSE_STEPS)
    opt = init_state(opt_cfg, tree)
    step = bundle.make_train_step(opt_cfg)
    # the fused AdamW pass a step: a norm launch a table of MAX_PARTS parts
    # and the finalize, an update launch a table
    tables = -(-sum(1 for p in parts if p.numel()) // MAX_PARTS)
    want_adamw = [(tables + 1, tables)] * DENSE_STEPS
    del tree, leaves, groups, parts, batch
    by_shape: dict = {}

    def tally(orig, q, k, v, **kw):
        n = flash_attention.launches
        o = orig(q, k, v, **kw)
        key = (q.shape[2], k.shape[2], kw["causal"])
        by_shape[key] = by_shape.get(key, 0) + flash_attention.launches - n
        return o

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, bwd_launches, times, losses, adamw = [], [], [], [], []
    adamw_sumsq.launches = adamw_step.launches = 0
    with attention_through(tally):
        for i in range(DENSE_STEPS):
            n0, nb = flash_attention.launches, flash_attention_bwd.launches
            a0 = (adamw_sumsq.launches, adamw_step.launches)
            t0 = time.perf_counter()
            model, opt, metrics = step(model, opt, batches(i))
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            launches.append(flash_attention.launches - n0)
            bwd_launches.append(flash_attention_bwd.launches - nb)
            adamw.append((adamw_sumsq.launches - a0[0],
                          adamw_step.launches - a0[1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase(f"  {DENSE_STEPS} steps of make_train_step (remat 'none', the "
          "default): losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {', '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"({rate(times[-1])} at the last), peak memory "
          f"{peak:.2f} GiB (weights, gradients and moments included); "
          f"flash launches per step {launches}, backward kernel launches "
          f"per step {bwd_launches}; fused AdamW launches per "
          f"step (adamw_sumsq, adamw_step) {adamw}")
    if not all(math.isfinite(x) for x in losses) or launches != [
            2 * sites] * DENSE_STEPS or bwd_launches != [
                bwd_sites] * DENSE_STEPS:
        fail(f"{label}: losses {losses}, launches {launches}, backward "
             f"kernel launches {bwd_launches}")
    if adamw != want_adamw:
        fail(f"{label}: fused AdamW launches per step {adamw}, expected "
             f"{want_adamw} ({tables} table(s) of parts)")
    return {"model": model, "opt": opt, "step": step, "times": times,
            "launches": sum(launches), "bwd_launches": sum(bwd_launches),
            "by_shape": by_shape, "adamw": sum(adamw[-1])}


def dense_training() -> dict:
    """Phase 11b: Qwen3-8B at full width and ``QWEN_TRAIN_LAYERS`` of its
    36 layers, bf16 parameters and gradients, f32 moments,
    ``TRAIN_DENSE`` synthetic tokens: :func:`train_check` (8 launches a
    pass, the generator's noise with remat off); then the steps under
    each of the remat policies ``"sublayers"`` and ``"off"``, and at the
    training shape the kernel's forward, the backward kernel (alone and
    through the Function, against its bound, two launches bitwise equal),
    the plain recompute it replaced and ``scaled_dot_product_attention``
    forward + backward timed, the kernel's gradients held to the
    recompute's (docs/port.md §train). Returns phase 5's flash row and
    the backward's."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import (
        attention,
        attention_chunked_ref,
    )
    from repro_torch.models import registry
    from repro_torch.parallel.hints import sharding_hints
    from repro_torch.train.data import DataConfig, SyntheticTokens

    t11 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("qwen3-8b"),
                              n_layers=QWEN_TRAIN_LAYERS)
    b, s = TRAIN_DENSE
    dev = "cuda"
    bundle = registry.build(cfg, device=dev)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    phase(f"phase 11b: training {cfg.name} at full width and "
          f"{cfg.n_layers} of 36 layers ({cfg.num_params():.0f} "
          f"parameters, bf16; AdamW moments f32), {b}x{s} synthetic tokens "
          f"a step: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          "weights")
    source = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=s,
                                        global_batch=b, seed=0))
    run = train_check(cfg, bundle, plain, model, source.batch_at,
                      lambda t: f"{b * s / t:.0f} tokens/s", "phase 11b",
                      sites=cfg.n_layers)
    model, opt, step, times = (run["model"], run["opt"], run["step"],
                               run["times"])
    n_train, n_bwd = run["launches"], run["bwd_launches"]
    # The same steps under the other policies: the last step's ms and the
    # peak memory of each.
    for policy, per_step in (("sublayers", 2 * cfg.n_layers),
                             ("off", cfg.n_layers)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, nb = [], flash_attention_bwd.launches
        with sharding_hints(remat=policy):
            for i in range(REMAT_STEPS):
                n0 = flash_attention.launches
                t0 = time.perf_counter()
                model, opt, metrics = step(model, opt, source.batch_at(
                    DENSE_STEPS + i))
                float(metrics["loss"])
                got.append((time.perf_counter() - t0,
                            flash_attention.launches - n0))
        nb = flash_attention_bwd.launches - nb
        phase(f"  remat {policy!r}: step ms "
              f"{', '.join(f'{t * 1e3:.1f}' for t, _ in got)}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, flash "
              f"launches per step {[n for _, n in got]}, backward kernel "
              f"launches {nb}")
        if ([n for _, n in got] != [per_step] * REMAT_STEPS
                or nb != cfg.n_layers * REMAT_STEPS):
            fail(f"phase 11b remat {policy}: launches {got}, backward "
                 f"kernel launches {nb}")
        n_train += sum(n for _, n in got)
        n_bwd += nb
    del model, opt, step, run, metrics
    torch.cuda.empty_cache()

    # At the train cell's launch shape (Qwen3-8B's here, and Mixtral-8x7B's
    # with its window of 4096, which does not bind at 2048): the kernel's
    # forward, the backward kernel alone and through the Function, the
    # plain recompute (the Function's backward before the kernel) and SDPA
    # forward + backward.
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = flash_inputs(g, b, cfg.n_heads, cfg.n_kv_heads, s, s,
                           cfg.head_dim, torch.bfloat16)
    err = check_close(f"flash training shape q {tuple(q.shape)} kv "
                      f"{tuple(k.shape)} bf16", flash_attention(
                          q, k, v).float(), flash_attention_plain(
                              q, k, v).float(), FLASH_TOL["bfloat16"])
    win = 4096
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = attention(*xs, window=win)
    go = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    _, lse, o = flash_attention(q, k, v, window=win, for_backward=True)
    fwd_ms, _ = cuda_ms(lambda: attention(q, k, v, window=win), 10)
    kern_ms, got = cuda_ms(lambda: flash_attention_bwd(
        q, k, v, o, lse, go, window=win), 20)
    again = flash_attention_bwd(q, k, v, o, lse, go, window=win)
    if not all(torch.equal(a, w) for a, w in zip(got, again)):
        fail("flash backward: two launches on the same inputs differ")
    fn_ms, _ = cuda_ms(lambda: torch.autograd.grad(
        out, xs, go, retain_graph=True), 20)

    def recompute():
        ref = attention_chunked_ref(*xs, window=win, chunk=512)
        return torch.autograd.grad(ref, xs, go)

    plain_ms, want = cuda_ms(recompute, 3)
    bwd_errs = [check_close(f"flash backward {name} at the training shape "
                            "vs the plain recompute", a.float(), w.float(),
                            FLASH_TOL["bfloat16"])
                for name, a, w in zip(("dq", "dk", "dv"), got, want)]
    bwd_rel = max(rel_l2(a, w) for a, w in zip(got, want))
    del want

    def sdpa_fb():
        oo = F.scaled_dot_product_attention(*xs, is_causal=True,
                                            enable_gqa=True)
        return torch.autograd.grad(oo, xs, go)

    sdpa_fb_ms, want = cuda_ms(sdpa_fb, 10)
    sdpa_f_ms, _ = sdpa_ms(q, k, v, 0)
    sdpa_rel = max(rel_l2(a, w) for a, w in zip(got, want))
    # five products of 2 D flops per kept (query, key) pair and head
    bwd_ops = 5 * 2 * cfg.head_dim * b * cfg.n_heads * kept_pairs(
        s, s, True, win)
    bwd_bound = bwd_ops / card_peaks()[2] * 1e3
    phase(f"  flash at the training shape: kernel forward {fwd_ms:.4f} ms; "
          f"backward kernel {kern_ms:.4f} ms ({bwd_bound / kern_ms:.1%} of "
          f"its {bwd_bound:.4f} ms bound, five products), through the "
          f"Function {fn_ms:.4f} ms, bitwise equal over two launches; the "
          f"plain recompute (chunk 512, the Function's backward before the "
          f"kernel) {plain_ms:.3f} ms; SDPA forward {sdpa_f_ms:.4f} ms, "
          f"forward + backward {sdpa_fb_ms:.4f} ms; dq, dk, dv vs the "
          f"recompute: rel L2 <= {bwd_rel:.3e}, vs SDPA's {sdpa_rel:.3e}")
    del xs, out, go, got, want, again, o, lse
    torch.cuda.empty_cache()
    phase(f"  phase 11b: {time.perf_counter() - t11:.1f} s")
    return {"qkv": (q, k, v), "window": 0, "launches": n_train,
            "errs": [err], "step_s": times[-1],
            "bwd": {"ms": kern_ms, "plain_ms": plain_ms, "ops": bwd_ops,
                    # q, o, dO and dQ; k, v, dK and dV: each moved once
                    "nbytes": 2 * 4 * (q.numel() + k.numel()),
                    "library_ms": sdpa_fb_ms, "err": max(bwd_errs),
                    "launches": n_bwd}}


def family_training() -> dict:
    """Phase 11d: each of ``TRAIN_FAMILIES`` at full width, bf16
    parameters and gradients, f32 moments, on ``make_batch``'s seeded
    train batches: :func:`train_check` with the keyed noise under the
    default remat (a site's forward runs again in the backward: Mixtral's
    and LLaVA's layers, Zamba2's groups of six Mamba2 layers and the
    shared block, whisper's encoder and decoder layers), Mixtral's
    experts held to the kernel run's. Then each launch shape of the
    steps, through the dispatcher, against the plain version. Returns
    phase 5's flash rows by name and each model's fused AdamW launches a
    step (docs/port.md §train)."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.models import registry
    from repro_torch.models.zamba2 import schedule

    t11 = time.perf_counter()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(9)
    rows, adamw = {}, {}
    for name, depth, (b, s) in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        layers = (f"{cfg.n_layers} + {cfg.n_layers}" if cfg.enc_dec
                  else f"{depth or cfg.n_layers} of {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=depth or cfg.n_layers)
        shape = ShapeConfig("train", s, b, "train")
        bundle = registry.build(cfg, device=dev)
        plain = registry.build(cfg, device=dev, use_kernel=False)
        model = bundle.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        inputs = ", ".join(f"{k} {tuple(v.shape)}" for k, v in
                           registry.input_specs(cfg, shape).items())
        phase(f"phase 11d: training {cfg.name} ({cfg.family}) at full width "
              f"and {layers} layers ({cfg.num_params():.0f} parameters, "
              f"bf16; AdamW moments f32), {inputs} a step: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights")
        if cfg.family == "audio":
            rate = lambda t: (f"{b * s / t:.0f} frames/s and "  # noqa: E731
                              f"{b * (s // 4) / t:.0f} tokens/s")
        elif cfg.family == "vlm":
            rate = lambda t: (f"{b * s / t:.0f} positions/s, "  # noqa: E731
                              f"{b * (s - cfg.n_frontend_tokens) / t:.0f} "
                              "loss tokens/s")
        else:
            rate = lambda t: f"{b * s / t:.0f} tokens/s"  # noqa: E731
        sites = (schedule(cfg)[0] if cfg.family == "hybrid"
                 else 3 * cfg.n_layers if cfg.enc_dec else cfg.n_layers)
        run = train_check(
            cfg, bundle, plain, model,
            lambda i: registry.make_batch(cfg, shape, seed=i, device=dev),
            rate, f"phase 11d {cfg.name}", sites=sites, keyed=True)
        by_shape, adamw[name] = run["by_shape"], run["adamw"]
        if sum(by_shape.values()) != run["launches"]:
            fail(f"phase 11d {cfg.name}: launches by shape {by_shape} != "
                 f"{run['launches']}")
        del model, bundle, plain, run
        torch.cuda.empty_cache()
        # each launch shape of the steps against the plain version
        for (sq, sk, causal), n in sorted(by_shape.items()):
            qkv = flash_inputs(g, b, cfg.n_heads, cfg.n_kv_heads, sq, sk,
                               cfg.head_dim, torch.bfloat16)
            kw = dict(causal=causal, window=cfg.sliding_window)
            group = cfg.n_heads // cfg.n_kv_heads
            label = ", ".join(
                [f"D {cfg.head_dim}"]
                + ([f"GQA {group}"] if group > 1 else [])
                + ([f"window {cfg.sliding_window}"]
                   if cfg.sliding_window else [])
                + ([f"Sq {sq}, Sk {sk}"] if sq != sk else [f"S {sq}"])
                + ([] if causal else ["non-causal"]) + ["training"])
            err = check_close(
                f"flash {cfg.name} training launch shape q "
                f"{tuple(qkv[0].shape)} kv {tuple(qkv[1].shape)} bf16 "
                f"({label}, {n} launches in the steps)",
                attention(*qkv, **kw).float(),
                flash_attention_plain(*qkv, **kw).float(),
                FLASH_TOL["bfloat16"])
            rows[f"flash_attention[{label}]"] = {
                "qkv": qkv, "window": cfg.sliding_window, "causal": causal,
                "launches": n, "errs": [err]}
        phase(f"  phase 11d {cfg.name}: {time.perf_counter() - t0:.1f} s")
    phase(f"  phase 11d: {time.perf_counter() - t11:.1f} s")
    return rows, adamw


def mla_training() -> dict:
    """Phase 11f: Kimi K2's multi-head latent attention trained on the
    card (docs/port.md §mla). ``kimi-k2-instruct`` at full width and the
    benchmark cell's cut (``MLA_TRAIN_LAYERS``, ``MLA_HELD`` of 384
    experts held, ``MLA_VOCAB``), bf16 parameters and f32 moments,
    ``DENSE_STEPS`` steps of ``make_train_step`` on ``make_batch``'s
    ``MLA_TRAIN`` tokens, the (192, 128) launch counters set to 0 just
    before: each step 2 forward launches a layer (the forward and the
    remat recompute) and 1 backward call, none at another pair, and
    ``mla.calls`` 2 a layer. Then at the cell's launch shape, laid out as
    the MLA block lays it out (q and k head-split views of (B, S, H, 192),
    v of the (B, S, H, 256) up-projection): the forward's output against
    ``flash_attention_plain``; its LSE, dq, dk and dv against
    ``attention_lse_ref`` and ``flash_attention_bwd_plain`` on every head,
    two at a time (the plain backward holds a (B, 2, S, S) f32 matrix);
    two launches of each kernel bitwise equal; the backward timed against
    its five-product bound beside the plain backward over all heads and
    SDPA forward + backward. Returns phase 5's forward row and the
    backward's."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch import tracing
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import param_tree
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    from repro_torch.models import registry
    from repro_torch.train.optimizer import AdamWConfig, init_state

    t0 = time.perf_counter()
    base = get_arch("kimi-k2-instruct")
    cfg = dataclasses.replace(base, n_layers=MLA_TRAIN_LAYERS,
                              vocab=MLA_VOCAB, moe=dataclasses.replace(
                                  base.moe, n_held=MLA_HELD))
    b, s = MLA_TRAIN
    h, pair = cfg.n_heads, (cfg.head_dim, cfg.v_head_dim)
    dev = "cuda"
    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    phase(f"phase 11f: training {cfg.name} at full width and "
          f"{cfg.n_layers} of {base.n_layers} layers, {cfg.moe.held} of "
          f"{cfg.moe.n_experts} experts held, vocabulary {cfg.vocab} "
          f"({cfg.num_params():.0f} parameters, bf16; AdamW moments f32), "
          f"{b}x{s} tokens a step: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights")
    shape = ShapeConfig("train", s, b, "train")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=DENSE_STEPS)
    opt = init_state(opt_cfg, param_tree(model))
    step = bundle.make_train_step(opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches_at[pair] = 0
    flash_attention_bwd.launches_at[pair] = 0
    fwd, bwd, other, calls, times, losses = [], [], [], [], [], []
    for i in range(DENSE_STEPS):
        f0 = flash_attention.launches_at[pair]
        g0 = flash_attention_bwd.launches_at[pair]
        n0 = flash_attention.launches + flash_attention_bwd.launches
        c0 = tracing.snapshot().get("mla.calls", 0)
        t = time.perf_counter()
        model, opt, metrics = step(model, opt, registry.make_batch(
            cfg, shape, seed=i, device=dev))
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t)
        fwd.append(flash_attention.launches_at[pair] - f0)
        bwd.append(flash_attention_bwd.launches_at[pair] - g0)
        other.append(flash_attention.launches + flash_attention_bwd.launches
                     - n0 - fwd[-1] - bwd[-1])
        calls.append(tracing.snapshot().get("mla.calls", 0) - c0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase(f"  {DENSE_STEPS} steps of make_train_step (remat 'none'): losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {', '.join(f'{t * 1e3:.1f}' for t in times)} "
          f"({b * s / times[-1]:.0f} tokens/s at the last), peak memory "
          f"{peak:.2f} GiB; (192, 128) launches per step: forward {fwd}, "
          f"backward {bwd}; flash launches at other pairs {other}; "
          f"mla.calls per step {calls}")
    n = cfg.n_layers
    if (not all(math.isfinite(x) for x in losses)
            or fwd != [2 * n] * DENSE_STEPS or bwd != [n] * DENSE_STEPS
            or other != [0] * DENSE_STEPS or calls != [2 * n] * DENSE_STEPS):
        fail(f"phase 11f: losses {losses}, (192, 128) launches forward "
             f"{fwd} and backward {bwd} (expected {2 * n} and {n} a step), "
             f"at other pairs {other}, mla.calls {calls} (expected "
             f"{2 * n})")
    del model, opt, step, metrics
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(12)

    def mk(width):
        return torch.randn((b, s, h, width), generator=g,
                           device=dev).bfloat16()

    # k_nope and v share the up-projection's (B, S, H, 256) rows
    q, k, do = (mk(w).transpose(1, 2) for w in (pair[0], pair[0], pair[1]))
    kv = mk(cfg.qk_nope_dim + pair[1])
    v = kv[..., cfg.qk_nope_dim:].transpose(1, 2)
    label = f"q = k {tuple(q.shape)}, v {tuple(v.shape)} bf16"
    out = flash_attention(q, k, v)
    o, lse, o32 = flash_attention(q, k, v, for_backward=True)
    again = flash_attention(q, k, v, for_backward=True)
    if not torch.equal(out, o) or not all(
            torch.equal(a, w) for a, w in zip((o, lse, o32), again)):
        fail("phase 11f: two (192, 128) forward launches on the same "
             "inputs differ")
    del again
    err = check_close(f"flash MLA training shape {label} vs plain",
                      o.float(), flash_attention_plain(q, k, v).float(),
                      FLASH_TOL["bfloat16"])
    kern_ms, got = cuda_ms(lambda: flash_attention_bwd(q, k, v, o32, lse,
                                                       do), 10)
    again = flash_attention_bwd(q, k, v, o32, lse, do)
    if not all(torch.equal(a, w) for a, w in zip(got, again)):
        fail("phase 11f: two (192, 128) backward launches on the same "
             "inputs differ")
    del again

    def plain_all():
        """The plain LSE and backward over every head, two at a time: the
        LSE's largest error, the gradients' largest, and each gradient's
        sums for its L2."""
        lse_err, grad_err, sums = 0.0, 0.0, [[0.0, 0.0] for _ in range(3)]
        for h0 in range(0, h, 2):
            hs = slice(h0, h0 + 2)
            want = attention_lse_ref(q[:, hs], k[:, hs])
            if not torch.allclose(lse[:, hs], want, **MLA_LSE_TOL):
                fail(f"phase 11f: the forward's LSE of heads {h0}-{h0 + 1} "
                     f"is not within {MLA_LSE_TOL} of attention_lse_ref")
            lse_err = max(lse_err, max_err(lse[:, hs], want))
            plain = flash_attention_bwd_plain(q[:, hs], k[:, hs], v[:, hs],
                                              o32[:, hs], lse[:, hs],
                                              do[:, hs])
            for j, (a, w) in enumerate(zip(got, plain)):
                grad_err = max(grad_err, max_err(a[:, hs], w))
                num, den = l2_sums(a[:, hs], w)
                sums[j][0] += num
                sums[j][1] += den
        return lse_err, grad_err, sums

    plain_ms, (lse_err, grad_err, sums) = cuda_ms(plain_all, 1)
    rels = [math.sqrt(num / den) for num, den in sums]
    phase(f"  flash MLA training shape {label}: LSE max abs err "
          f"{lse_err:.3e} ({MLA_LSE_TOL}); dq, dk, dv vs the plain backward "
          f"over all {h} heads: rel L2 "
          + ", ".join(f"{r:.3e}" for r in rels)
          + f" (<= {MLA_GRAD_REL_L2}), max abs err {grad_err:.3e}")
    if not all(r <= MLA_GRAD_REL_L2 for r in rels):
        fail(f"phase 11f: dq, dk, dv rel L2 {rels} > {MLA_GRAD_REL_L2}")
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def sdpa_fb():
        oo = F.scaled_dot_product_attention(*xs, is_causal=True)
        return torch.autograd.grad(oo, xs, do)

    sdpa_fb_ms, want = cuda_ms(sdpa_fb, 5)
    sdpa_f_ms, _ = sdpa_ms(q, k, v, 0)
    sdpa_rel = max(rel_l2(a, w) for a, w in zip(got, want))
    del xs, want
    # five products, 2 flop a column of each: S = Q K^T and dK = dS^T Q,
    # dQ = dS K over D; dP = dO V^T and dV = P^T dO over Dv
    ops = 2 * (3 * pair[0] + 2 * pair[1]) * b * h * kept_pairs(s, s, True, 0)
    bound = ops / card_peaks()[2] * 1e3
    phase(f"  flash MLA backward at the training shape: {kern_ms:.4f} ms "
          f"({bound / kern_ms:.1%} of its {bound:.4f} ms bound, five "
          f"products), bitwise equal over two launches; the plain backward "
          f"over all heads {plain_ms:.2f} ms; SDPA forward "
          f"{sdpa_f_ms:.4f} ms, forward + backward {sdpa_fb_ms:.4f} ms "
          f"(its dq, dk, dv vs the kernel's: rel L2 <= {sdpa_rel:.3e})")
    del got, o, lse, o32, out, kv, do
    torch.cuda.empty_cache()
    phase(f"  phase 11f: {time.perf_counter() - t0:.1f} s")
    # phase 5 times the forward on contiguous copies and on head-split
    # views of them
    return {"fwd": {"qkv": tuple(x.contiguous() for x in (q, k, v)),
                    "window": 0, "launches": sum(fwd), "errs": [err]},
            "bwd": {"ms": kern_ms, "plain_ms": plain_ms, "ops": ops,
                    # q, dQ, k, dK at D; v, dV, o and dO at Dv: each moved
                    # once in bf16
                    "nbytes": 2 * 2 * (q.numel() + k.numel() + v.numel()
                                       + b * h * s * pair[1]),
                    "library_ms": sdpa_fb_ms, "err": grad_err,
                    "launches": sum(bwd)}}


def adamw_pass() -> dict:
    """Phase 11e: the fused AdamW pass (``csrc/adamw.cu``) at the train
    cell's parts (Mixtral-8x7B at 2 layers: 13 leaves, 23 parts, 3.16 B
    parameters; bf16 parameters and gradients, f32 moments, the cell's
    optimizer settings). The library's registers and spills (a spill
    fails); the norm against ``_global_norm``; the kernel pair (norm,
    scale and update: ``apply_updates``' launches), the plain pass and
    the library's ``torch._fused_adamw_`` timed by CUDA events beside the
    bound (each state word read and written once over the card's HBM
    rate); then one launch over the whole 23-part table from the state
    the timing left, held bitwise to ``_update`` of each part from a host
    copy of that state. Returns the ``kernels`` line's row."""
    import torch

    with torch.no_grad():
        return _adamw_pass()


def _adamw_pass() -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.interop import Stacked, param_tree
    from repro_torch.kernels import build
    from repro_torch.kernels.adamw.adamw import adamw_step, adamw_sumsq
    from repro_torch.models import registry
    from repro_torch.train import optimizer as topt
    from repro_torch.train.checkpoint import tree_map

    t0 = time.perf_counter()
    hbm = card_peaks()[0]
    dev = "cuda"
    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), n_layers=2)
    opt_cfg = topt.AdamWConfig(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                               weight_decay=0.1, clip_norm=1.0)
    model = registry.build(cfg, device="meta").init()
    model.to_empty(device=dev)
    params = param_tree(model)
    gen = torch.Generator(device=dev).manual_seed(11)

    def draw(x, sd):
        return torch.randn(x.shape, device=dev, generator=gen).mul_(sd).to(
            x.dtype)

    def like(leaf, sd):
        if isinstance(leaf, Stacked):
            return Stacked([draw(p, sd) for p in leaf.parts])
        return draw(leaf, sd)

    tree_map(lambda leaf: [p.copy_(draw(p, 0.02)) for p in (
        leaf.parts if isinstance(leaf, Stacked) else [leaf])], params)
    grads = tree_map(lambda leaf: like(leaf, 1e-4), params)
    state = topt.init_state(opt_cfg, params)
    parts = topt._parts(params, grads, state)
    n = sum(p.p.numel() for p in parts)
    nbytes = sum(p.p.numel() * (2 * p.p.element_size() + 2 * p.g.element_size()
                                + 4 * p.m.element_size()) for p in parts)
    bound_ms = nbytes / hbm * 1e3
    phase(f"phase 11e: the fused AdamW pass at the train cell's parts: "
          f"{len(parts)} parts of {cfg.name} at 2 layers, {n:,} parameters "
          f"(bf16, f32 moments), {nbytes / 1e9:.2f} GB each state word "
          f"once: bound {bound_ms:.2f} ms at {hbm / 1e12:.2f} TB/s")
    # the library's registers and spills
    log = build.library_path("adamw", build.adamw_source()).with_suffix(
        ".log")
    out = adamw_sumsq(parts, opt_cfg.clip_norm)
    torch.cuda.synchronize()
    for fn, (regs, spill) in sorted(build.ptxas_usage(log.read_text())
                                    .items()):
        phase(f"  ptxas {fn}: {regs} registers, {spill} spill bytes")
        if spill:
            fail(f"phase 11e: {fn} spills {spill} bytes")
    want = topt._global_norm(grads)
    rel = abs(float(out[0]) - float(want)) / float(want)
    phase(f"  global norm {float(out[0]):.6e} vs _global_norm "
          f"{float(want):.6e}: rel {rel:.2e} (<= 1e-5), scale "
          f"{float(out[1]):.6e}")
    if rel > 1e-5:
        fail(f"phase 11e: the norm is {rel:.2e} from plain's")
    step = state["step"] + 1
    lr = topt.lr_at(opt_cfg, state["step"])
    bc1 = 1 - opt_cfg.b1 ** step.float()
    bc2 = 1 - opt_cfg.b2 ** step.float()
    kw = dict(b1=opt_cfg.b1, b2=opt_cfg.b2, eps=opt_cfg.eps,
              weight_decay=opt_cfg.weight_decay)

    def fused():
        o = adamw_sumsq(parts, opt_cfg.clip_norm)
        adamw_step(parts, lr, o[1], bc1, bc2, **kw)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms, _ = cuda_ms(fused, iters=20)
    fused_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    plain_ms, _ = cuda_ms(lambda: topt._plain_pass(opt_cfg, parts, lr, bc1,
                                                   bc2), iters=3)
    plain_peak = torch.cuda.max_memory_allocated() - base
    # The library's fused AdamW takes one dtype for p, g, m and v, so it
    # runs on f32 copies of p and g beside the f32 moments: 28 bytes a
    # parameter, no norm and no clip.
    p32 = [pt.p.float() for pt in parts]
    g32 = [pt.g.float() for pt in parts]
    steps = [torch.ones((), device=dev) for _ in parts]
    lib_ms, _ = cuda_ms(lambda: torch._fused_adamw_(
        p32, g32, [pt.m for pt in parts], [pt.v for pt in parts], [], steps,
        lr=opt_cfg.lr, beta1=opt_cfg.b1, beta2=opt_cfg.b2,
        weight_decay=opt_cfg.weight_decay, eps=opt_cfg.eps, amsgrad=False,
        maximize=False), iters=5)
    lib_bytes = 28 * n
    del p32, g32, steps
    torch.cuda.empty_cache()
    phase(f"  kernel pair: {ms:.3f} ms a step, {bound_ms / ms:.1%} of the "
          f"{bound_ms:.2f} ms bound ({nbytes / ms / 1e6:.0f} GB/s), "
          f"{ms / bound_ms:.2f}x it; plain pass {plain_ms:.2f} ms "
          f"({plain_ms / ms:.1f}x); temporaries {fused_peak / 2**30:.2f} vs "
          f"{plain_peak / 2**30:.2f} GiB; library torch._fused_adamw_ "
          f"{lib_ms:.3f} ms on f32 p and g ({lib_bytes / 1e9:.2f} GB, "
          f"{lib_bytes / lib_ms / 1e6:.0f} GB/s, no norm)")
    if ms > 1.35 * bound_ms:
        fail(f"phase 11e: the kernel pair takes {ms / bound_ms:.2f}x its "
             "bound (> 1.35)")
    # One launch over the whole table, from the state the timing left,
    # against _update of each part from a host copy of that state.
    scalars = (lr, adamw_sumsq(parts, opt_cfg.clip_norm)[1], bc1, bc2)
    before = [[x.cpu() for x in (pt.p, pt.m, pt.v)] for pt in parts]
    n0 = adamw_step.launches
    adamw_step(parts, *scalars, **kw)
    if adamw_step.launches - n0 != 1:
        fail(f"phase 11e: {adamw_step.launches - n0} launches for "
             f"{len(parts)} parts")
    err, unequal = 0.0, []
    for pt, host in zip(parts, before):
        p, m, v = (x.to(dev) for x in host)
        topt._update(opt_cfg, p, pt.g, m, v, *scalars, pt.decay)
        for role, ref in zip("pmv", (p, m, v)):
            got = getattr(pt, role)
            err = max(err, float((got.float() - ref.float()).abs().max()))
            if not torch.equal(got, ref):
                unequal.append(f"{pt.name} {role}")
        del p, m, v
    del before
    verdict = ("unequal: " + ", ".join(unequal) if unequal
               else "bitwise equal")
    phase(f"  adamw_step, one launch over the {len(parts)}-part table, vs "
          f"_update of each part: max abs err {err:.3e} (p, m, v; "
          f"{verdict})")
    if unequal:
        fail(f"phase 11e: differs from _update's: {', '.join(unequal)}")
    del model, params, grads, state, parts
    torch.cuda.empty_cache()
    phase(f"  phase 11e: {time.perf_counter() - t0:.1f} s")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "nbytes": nbytes, "ops": 20 * n, "n": n, "err": err}


#: Argument bytes of the dry run against what the card allocates for the
#: same tensors: the caching allocator rounds each block up (512 B).
ARGS_RTOL = 5e-3
#: Phase 12(c): the production cells traced on the 16x16 meta mesh.
DRYRUN_CELLS = (("qwen3-8b", "prefill_32k"), ("qwen3-8b", "decode_32k"),
                ("mixtral-8x7b", "train_4k"))


def dryrun_vs_card(card_line: str, prefill_wall: float,
                   step_s: float) -> None:
    """Phase 12: the dry run (``launch/dryrun.py``, traced on ``meta``)
    against the card. (a) Qwen3-8B's prefill at phase 6's 4x2048 on a 1x1
    mesh: the argument bytes within ``ARGS_RTOL`` of what the card
    allocates for the model and the batch, the peak temporaries beside
    the plain prefill's, the flops equal to the ``CostMode`` count of the
    same prefill run on the card with plain attention, and phase 6's
    kernel prefill's TFLOP/s by that count; (b) the same for phase 11b's
    training step (8 layers, 2x2048, AdamW moments included), whose flops
    count the remat recompute, the card's step unrolled against the dry
    run's; (c) the ``DRYRUN_CELLS`` through ``run_cell`` on the 16x16
    production mesh, per-rank bytes beside the card's memory."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.interop import param_tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import CostMode
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import registry
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import AdamWConfig, init_state

    t12 = time.perf_counter()
    hbm, _, bf16 = card_peaks()
    one = Mesh((1, 1), ("data", "model"), [torch.device("meta")])
    dev = "cuda"
    phase("phase 12: the dry run against the card")
    phase(f"  {card_line}")

    def placed(cfg, shape, art, build_args):
        """The model (zeros: its values do not change a count) and the
        batch of ``shape`` placed on the card, and whatever
        ``build_args`` adds, against the dry run's argument bytes."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = Transformer(cfg, device=dev)
        for p in model.parameters():
            p.zero_()
        batch = registry.make_batch(cfg, shape, 0, dev)
        extra = build_args(model)
        grown = torch.cuda.memory_allocated() - base
        want = art["memory"]["argument_size_in_bytes"]
        rel = abs(grown - want) / want
        phase(f"    argument bytes: dry run {want:,} vs allocated "
              f"{grown:,} on the card (rel {rel:.2e} <= {ARGS_RTOL})")
        if not rel <= ARGS_RTOL:
            fail(f"phase 12 {cfg.name}: argument bytes {want} vs "
                 f"allocated {grown}")
        return model, batch, extra

    def counted(art, label, fn):
        """``fn()`` on the card under a CostMode: its flops equal to the
        dry run's, its peak allocation beside the dry run's temporaries."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with CostMode() as mode:
            fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        want = art["hlo_cost"]["global"]["flops"]
        temp = art["memory"]["temp_size_in_bytes"]
        phase(f"    flops: dry run on meta {want:.6e}, the card's {label} "
              f"under CostMode {mode.flops:.6e} "
              f"({'equal' if mode.flops == want else 'DIFFERENT'}); peak "
              f"temporaries: dry run {temp / 2**30:.2f} GiB, the card "
              f"{peak / 2**30:.2f} GiB above the arguments (ratio "
              f"{temp / peak:.3f}); dry run traced in {art['trace_s']} s")
        if mode.flops != want:
            fail(f"phase 12 {label}: flops {mode.flops} on the card != "
                 f"{want} on meta")

    # (a) the prefill
    cfg = get_arch("qwen3-8b")
    b, s = PREFILL
    shape = ShapeConfig("prefill", s, b, "prefill")
    art = dryrun.dry_run(cfg, shape, one)
    phase(f"  (a) {cfg.name} prefill {b}x{s} on a 1x1 mesh")
    model, batch, _ = placed(cfg, shape, art, lambda m: None)
    plain = registry.build(cfg, device=dev, use_kernel=False)
    prefill = plain.make_prefill_step()
    counted(art, "plain prefill", lambda: prefill(model, batch))
    flops, proxy = art["hlo_cost"]["flops"], art["hlo_cost"]["hbm_proxy_bytes"]
    phase(f"    phase 6's kernel prefill {prefill_wall * 1e3:.1f} ms: "
          f"{flops / prefill_wall / 1e12:.1f} TFLOP/s by the dry run's "
          f"count, {flops / prefill_wall / bf16:.3f} of {bf16 / 1e12:.0f} "
          f"bf16; HBM proxy {proxy / 1e9:.1f} GB / {hbm / 1e12:.2f} TB/s = "
          f"{proxy / hbm * 1e3:.1f} ms against the wall")
    del model, batch, plain, prefill

    # (b) the training step
    cfg = dataclasses.replace(get_arch("qwen3-8b"),
                              n_layers=QWEN_TRAIN_LAYERS)
    b, s = TRAIN_DENSE
    shape = ShapeConfig("train", s, b, "train")
    art = dryrun.dry_run(cfg, shape, one, num_microbatches=1)
    phase(f"  (b) {cfg.name} at {cfg.n_layers} layers, train {b}x{s} on a "
          "1x1 mesh (AdamW moments f32)")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=DENSE_STEPS)
    model, batch, opt = placed(
        cfg, shape, art, lambda m: init_state(opt_cfg, param_tree(m)))
    step = registry.build(cfg, device=dev, use_kernel=False).make_train_step(
        opt_cfg)
    counted(art, "plain train step", lambda: step(model, opt, batch))
    flops = art["hlo_cost"]["flops"]
    phase(f"    phase 11b's kernel step {step_s * 1e3:.1f} ms: "
          f"{flops / step_s / 1e12:.1f} TFLOP/s by the dry run's count "
          f"(remat recompute included), {flops / step_s / bf16:.3f} of "
          f"{bf16 / 1e12:.0f} bf16")
    del model, batch, opt, step
    torch.cuda.empty_cache()

    # (c) production cells on the meta mesh
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, shape_name in DRYRUN_CELLS:
        art = dryrun.run_cell(arch, shape_name, multi_pod=False, save=False)
        mem, cost = art["memory"], art["hlo_cost"]
        phase(f"  (c) {arch} x {shape_name} x {art['mesh']}: per rank "
              f"args {mem['argument_size_in_bytes'] / 2**30:.2f} GiB + temp "
              f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB beside the "
              f"card's {total / 2**30:.2f} GiB; flops/dev "
              f"{cost['flops']:.3e}, coll/dev "
              f"{cost['coll_bytes'] / 2**30:.3f} GiB; traced in "
              f"{art['trace_s']} s")
    phase(f"  phase 12: {time.perf_counter() - t12:.1f} s")


def sdpa_ms(q, k, v, window: int, causal: bool = True) -> tuple[float, str]:
    """CUDA-event ms of one ``scaled_dot_product_attention`` call on the
    kernel's inputs (GQA; causal where ``causal``, which here has Sq ==
    Sk, where SDPA's diagonal is the kernel's), and the backend that ran.
    SDPA has no window argument: a window is given as an explicit boolean
    mask, and each backend is tried in turn (cuDNN, memory-efficient,
    math); the fastest that takes the call is reported."""
    import torch
    import torch.nn.functional as F

    if not window:
        gqa = q.shape[1] != k.shape[1]
        ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=gqa), 20)
        return ms, (f"is_causal={causal}" + (", enable_gqa" if gqa else "")
                    + ", default dispatch")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sq, sk = q.shape[2], k.shape[2]
    qi = torch.arange(sk - sq, sk, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = (qi >= ki) & (qi - ki < window)
    best = None
    for backend in (SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:  # a backend that cannot take the call warns, then raises
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), 5)
        except RuntimeError:
            continue
        if best is None or ms < best[0]:
            best = (ms, f"boolean attn_mask, enable_gqa, {backend.name}")
    if best is None:
        fail("scaled_dot_product_attention took the windowed call on no "
             "backend")
    return best


def example(name: str):
    """``examples/<name>.py`` of this checkout, imported as a module."""
    import importlib.util

    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


#: The LBM example on the card: a 2048² cavity (9 f32 planes, 151 MB of
#: state per checkpoint), m 4, a checkpoint every 100 steps.
LBM_EXAMPLE = ["--height", "2048", "--width", "2048", "--m", "4",
               "--ckpt-every", "100"]


def paper_flow() -> None:
    """Phase 10: the paper's flow as a user runs it, the port's three
    examples on the card (docs/port.md §examples): the quickstart, the
    DSE walkthrough (``--topk 1``) and the LBM cavity with checkpoint and
    restart, the restarted run bitwise equal to the unbroken one."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.train import checkpoint as ckpt

    t10 = time.perf_counter()
    phase("phase 10: the paper's flow: the port's examples on the card")
    tmp = tempfile.mkdtemp(prefix="phase10-")
    saved_env = {k: os.environ.get(k) for k in
                 ("REPRO_TORCH_MEASURE_CACHE", "REPRO_TORCH_STUDY_DIR")}
    try:
        # (a) the quickstart, against the same f32 operations in numpy
        got, text = run_quiet(example("torch_quickstart").main, [])
        t = np.arange(8, dtype=np.float32)
        t1, t2 = t * (t + 1), (t + 2) + (t + 3)
        want = {"z1": t1 - t2, "z2": t1 / t2 + np.float32(123.456),
                "bout1": t2}
        for key, value in want.items():
            if not np.allclose(got[key], value, rtol=1e-6, atol=0):
                fail(f"torch_quickstart {key} {got[key]} != {value}")
        if not got["cascade_equal"] or "(n=1, m=4)" not in text:
            fail(f"torch_quickstart output: {text}")
        phase(f"  torch_quickstart on the card: z1, z2, bout1 == numpy f32 "
              f"(rtol 1e-6), cascade == 4 sequential applications; "
              f"{len(text.splitlines())} lines printed")

        # (b) the DSE walkthrough, its cache and studies in a scratch dir
        os.environ["REPRO_TORCH_MEASURE_CACHE"] = os.path.join(tmp, "mc.json")
        os.environ["REPRO_TORCH_STUDY_DIR"] = os.path.join(tmp, "studies")
        t0 = time.perf_counter()
        report, text = run_quiet(example("torch_dse_explore").main,
                                 ["--topk", "1"])
        wall = time.perf_counter() - t0
        if "-> best configuration: (n, m) = (1, 4)" not in text:
            fail("torch_dse_explore: section 1 did not pick (1, 4)")
        for app in ("lbm", "diffusion"):
            ex = report[app]["executed"]
            if not ex or any(e["interpret"] for e in ex):
                fail(f"torch_dse_explore {app}: nothing executed on the card")
            for e in ex:
                phase(f"  torch_dse_explore {app}: block_h {e['block_h']}, "
                      f"m {e['m']}, d {e['d']}: "
                      f"{e['measured_gflops']:.1f} GF/s measured, "
                      f"{e['measured_mlups']:.0f} MLUPS, calibrated "
                      f"rel_error {e['rel_error']:+.3f}")
        phase(f"  torch_dse_explore --topk 1: {wall:.2f} s (the calibration "
              "and kernels of phase 7 are reused in this process)")

        # (c) the LBM cavity: unbroken, then broken at 200 and resumed
        lbm = example("torch_lbm_simulation")
        runs = {}
        for key, steps, where in (("whole", 400, "a"), ("first", 200, "b"),
                                  ("resumed", 400, "b")):
            runs[key], text = run_quiet(lbm.main, LBM_EXAMPLE + [
                "--steps", str(steps), "--ckpt-dir", os.path.join(tmp, where)])
            for line in text.splitlines():
                if line.startswith("[lbm]") and ("steps" in line
                                                 or "restored" in line):
                    phase(f"  torch_lbm_simulation {key}: {line}")
        whole, resumed = runs["whole"], runs["resumed"]
        if resumed["start"] != 200 or resumed["done"] != 400:
            fail(f"the LBM restart did not resume at 200: {resumed['start']}")
        check_equal("LBM 2048^2 restarted at step 200, f at step 400 vs the "
                    "unbroken run", resumed["f"], whole["f"])
        t0 = time.perf_counter()
        step, tree, _ = ckpt.restore_latest(os.path.join(tmp, "a"),
                                            {"f": whole["f"]})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 400 or not tree["f"].is_cuda:
            fail(f"restore_latest: step {step}, device {tree['f'].device}")
        check_equal("the step-400 checkpoint restored vs the saved f",
                    tree["f"], whole["f"])
        saves = whole["save_s"] + runs["first"]["save_s"] + resumed["save_s"]
        mb = whole["f"].numel() * whole["f"].element_size() / 1e6
        phase(f"  LBM 2048^2 m 4: {whole['mlups']:.1f} MLUPS over 400 steps "
              f"with 4 saves; {len(saves)} saves of {mb:.0f} MB, "
              f"{sum(saves) / len(saves):.3f} s each (max "
              f"{max(saves):.3f}); restore {resumed['restore_s']:.3f} s in "
              f"the example, {restore_s:.3f} s here")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    phase(f"  phase 10: {time.perf_counter() - t10:.1f} s")


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
            pick = sweep.best(key="sustained_gflops")
            at = (pick.detail["block_rows"], pick.m)
            mine = [e for e in full.executed if (e.block_h, e.m) == at]
            if not mine:
                fail(f"{label}: the model's pick {at} was not measured")
            phase(f"  {label} model's pick (block_h {at[0]}, m {at[1]}) "
                  f"{mine[0].measured_mlups:.1f} MLUPS beside the measured "
                  f"best's {fb.measured_mlups:.1f}: "
                  f"{mine[0].measured_mlups / fb.measured_mlups:.3f} of it")
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


#: Phase 8's plans: (block_h, m) of the uLBM program at 4096² and of
#: advection-diffusion at 8192².
LBM_PLAN, AD_PLAN = (16, 4), (32, 4)


def program_sims():
    """The uLBM 4096² and advection-diffusion 8192² simulations of phase 8
    (no state yet: their programs lower on the host)."""
    from repro_torch.apps import lbm
    from repro_torch.apps.advection_diffusion import (
        AdvectionDiffusionSimulation,
    )

    return (lbm.LBMSimulation(lbm.LBMProblem(4096, 4096)),
            AdvectionDiffusionSimulation(8192, 8192))


def cluster_programs(sims) -> dict:
    """``{core name: StripeProgram}`` of every cluster span of both
    programs (six of the uLBM program, three of advection-diffusion)."""
    out = {}
    for prog in (sims[0].program(), sims[1].program):
        for lo in range(prog.nstages):
            for hi in range(lo + 1, prog.nstages + 1):
                p = prog.cluster_kernel(lo, hi).program
                out[p.name] = p
    return out


def stream_programs(sims, hbm: float, record) -> None:
    """Phase 8: stream programs on the card (docs/port.md §program)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch import cli
    from repro_torch.apps import lbm
    from repro_torch.apps.advection_diffusion import (
        advdiff_ref_run,
        blob_init,
    )
    from repro_torch.core.codegen import StripeProgram
    from repro_torch.core.program import fusion_partitions
    from repro_torch.kernels.spd_stream.spd_stream import spd_multistep_plain
    from repro_torch.kernels.spd_stream.streaming import (
        spd_multistep_halo_streamed,
        spd_multistep_streamed,
    )

    phase("phase 8: stream programs on the card")
    t8 = time.perf_counter()
    tsim, asim = sims
    tprog, aprog = tsim.program(), asim.program
    f, attr, _ = lbm.taylor_green_init(4096, 4096)
    tstate, tregs = tsim.stream_state(f, attr), tsim.stream_regs()
    del f, attr
    u0 = blob_init(8192, 8192)
    astate, aregs = asim.state(u0), asim.regs()
    cases = (("uLBM program 4096^2 TGV", tprog, tstate, tregs, LBM_PLAN,
              tsim.stream_kernel()),
             ("advection-diffusion 8192^2 blob", aprog, astate, aregs,
              AD_PLAN, asim.monolithic_core.stream_kernel()))

    # Which tile and which state each cluster's launch takes at its plan.
    for label, prog, state, _, (bh, m), _ in cases:
        w = state.shape[2]
        for spec in fusion_partitions(prog.nstages):
            pk = prog.kernel(spec)
            m_c = 1 if pk.pipelined else m
            for kern in pk.clusters:
                p = kern.program
                bw, db = kern.tile(w, bh, m_c)
                where = ("registers (owned)" if p.owned(bh, bw, m_c)
                         else "the load slot" if p.reg_state
                         else "shared memory")
                smem = p.smem_bytes(bh, bw, m_c, streamed=True,
                                    double_buffer=db)
                phase(f"  {label.split()[0]} {spec}: {p.name} (P {p.P}, "
                      f"K {p.K}, halo {p.halo}/{p.halo_x}) tile "
                      f"{bh}x{bw} at m {m_c}, prefetch {db}, state in "
                      f"{where}, {smem} B")

    def per_launch_ms(state) -> float:
        """Bound of one launch over ``state``: its planes read and
        written once over the card's memory rate."""
        return 2 * state.numel() * 4 / hbm * 1e3

    names = {p.name for p in cluster_programs(sims).values()}

    def zero() -> None:
        spd_multistep_streamed.launches = 0
        spd_multistep_halo_streamed.launches = 0
        StripeProgram.launches.clear()

    def cluster_launches() -> int:
        return sum(n for k, n in StripeProgram.launches.items()
                   if k in names)

    def take(what: str) -> dict:
        """The cluster cores' launches since the counts were last set to
        0, printed as those of ``what``."""
        got = {k: n for k, n in sorted(StripeProgram.launches.items())
               if k in names}
        phase(f"  launches {what}: {got}")
        return got

    # 8a, 8b: every partition against the monolithic kernel: the main
    # path, whose launch counts the kernels line reports.
    zero()
    singles = {}
    for label, prog, state, regs, (bh, m), mono in cases:
        want = mono.run_blocked(state, regs, steps=8, m=m, block_h=bh)
        oracle = None
        if prog is aprog:
            oracle = advdiff_ref_run(u0, *regs, 8)
        launch_bound = per_launch_ms(state)
        for spec in fusion_partitions(prog.nstages):
            pk = prog.kernel(spec)
            run = lambda n: pk.run_blocked(  # noqa: E731
                state, regs, steps=n, m=m, block_h=bh)
            got = run(8)
            check_equal(f"{label} {spec} (block {bh}, m {m}, 8 steps) == "
                        f"{mono.program.name}", got, want)
            if oracle is not None:
                check_close(f"{label} {spec} vs the torch oracle", got[0],
                            oracle, dict(rtol=0, atol=1e-5))
            singles[(prog.name, spec)] = got
            before = cluster_launches()
            run(8)
            per_step = (cluster_launches() - before) / 8
            ms8, _ = cuda_ms(lambda: run(8), 5)
            ms32, _ = cuda_ms(lambda: run(32), 5)
            phase(f"    {spec}: {ms8 / 8:.4f} ms per step over 8 steps "
                  f"(marginal {(ms32 - ms8) / 24:.4f} ms over 32), "
                  f"{per_step:g} launches per step, bound "
                  f"{per_step * launch_bound:.4f} ms per step "
                  f"({per_step:g} x {launch_bound:.4f}); "
                  f"{state.shape[1] * state.shape[2] / (ms8 / 8) / 1e3:.0f}"
                  " MLUPS")
        del want, oracle
        torch.cuda.empty_cache()
    launches = take("on the program path (8a, 8b)")
    for name in sorted(names):
        if not launches.get(name):
            fail(f"cluster core {name} was not launched on the program "
                 "path")

    # 8c: no host synchronization on the pipelined path.
    zero()
    pk = tprog.kernel("1+1+1")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    outs, enqueue = [], []
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            outs.append(pk.run_blocked(tstate, tregs, steps=8, m=4,
                                       block_h=16))
            enqueue.append(time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        check_equal(f"uLBM program 1+1+1 under set_sync_debug_mode('error')"
                    f", run {i + 1} (host enqueue {enqueue[i] * 1e3:.2f} ms "
                    "for 8 steps)", out, singles[(tprog.name, "1+1+1")])
    del outs
    ssim = lbm.LBMSimulation(lbm.LBMProblem(1024, 1024))
    f, attr, _ = lbm.taylor_green_init(1024, 1024)
    sstate, sregs = ssim.stream_state(f, attr), ssim.stream_regs()
    spk = ssim.program().kernel("1+1+1")
    walls = {}
    for how, fn in (
            ("pipelined", lambda: spk.run_blocked(sstate, sregs, steps=8,
                                                  m=1, block_h=16)),
            ("unfused", lambda: spk.run_unfused(sstate, sregs, steps=8,
                                                block_h=16))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[how] = (out, time.perf_counter() - t0)
    check_equal("uLBM program 1024^2 1+1+1 run_unfused == pipelined",
                walls["unfused"][0], walls["pipelined"][0])
    phase(f"    1024^2, 8 steps: pipelined {walls['pipelined'][1] * 1e3:.2f}"
          f" ms, run_unfused {walls['unfused'][1] * 1e3:.2f} ms (host "
          "clock, synchronized)")
    del walls, sstate, f, attr
    take("by the sync check and the 1024^2 runs (8c)")

    # 8d: one partition of each app on a (2, 2) mesh of one card.
    zero()
    mesh = ["cuda:0"] * 4
    for label, prog, state, regs, (bh, m), spec, steps in (
            ("uLBM program 4096^2", tprog, tstate, tregs, LBM_PLAN, "1+2",
             4),
            ("advection-diffusion 8192^2", aprog, astate, aregs, AD_PLAN,
             "2", 8)):
        pk = prog.kernel(spec)
        one = pk.run_blocked(state, regs, steps=steps, m=m if not
                             pk.pipelined else 1, block_h=bh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pk.run_blocked(state, regs, steps=steps, m=m if not
                             pk.pipelined else 1, block_h=bh, d=4, dx=2,
                             devices=mesh)
        torch.cuda.synchronize()
        check_equal(f"{label} {spec} on a (2, 2) mesh of cuda:0 x4 "
                    f"({(time.perf_counter() - t0) * 1e3:.1f} ms, {steps} "
                    "steps) == one device", got, one)
    del one, got
    torch.cuda.empty_cache()
    take("on the mesh path (8d)")

    # 8e: the CLI's program search, twice (the repeat is the cache's).
    zero()
    tmp = tempfile.mkdtemp(prefix="programs-")
    try:
        os.environ["REPRO_TORCH_MEASURE_CACHE"] = os.path.join(tmp, "c.json")
        argv = ["explore", "--program", "--strategy", "halving", "--budget",
                "12", "--json", os.path.join(tmp, "r.json")]
        runs = []
        for i in range(2):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                runs.append(cli.main(argv))
            sec = text.getvalue().split("3c) Stream programs")[1]
            for line in sec.splitlines():
                if line.startswith(("-- ", "(strategy", "-> best")) or (
                        i == 0 and line.startswith("| ")
                        and " live |" in line):
                    phase(f"  cli --program run {i + 1}: {line}")
        for app, n in (("lbm_program", 3), ("advection_diffusion", 2)):
            first, again = (r["program"][app] for r in runs)
            spent = first["budget_spent"]
            if not first["executed"] or not 0 < spent <= 12:
                fail(f"cli --program {app}: {spent} live measurements for "
                     f"{len(first['executed'])} points (budget 12)")
            if again["budget_spent"] != 0:
                fail(f"cli --program {app} repeat spent "
                     f"{again['budget_spent']} live measurements")
            for e in first["executed"] + again["executed"]:
                if e["interpret"] or e["fusion"] not in fusion_partitions(n):
                    fail(f"cli --program {app}: executed point {e}")
            phase(f"  cli --program {app}: budget_spent {spent} <= 12, "
                  f"repeat 0, declined {first['declined']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    take("by the CLI's two searches (8e)")

    # 8f: every cluster core against its bound and its plain version, at
    # its main-path shape (m when it runs fused, 1 when pipelined).
    fused = {tprog.cluster_kernel(0, 3).program.name: LBM_PLAN[1],
             aprog.cluster_kernel(0, 2).program.name: AD_PLAN[1]}
    for prog, state, regs, (bh, _) in ((tprog, tstate, tregs, LBM_PLAN),
                                       (aprog, astate, aregs, AD_PLAN)):
        buf = torch.empty_like(state)
        for lo in range(prog.nstages):
            for hi in range(lo + 1, prog.nstages + 1):
                kern = prog.cluster_kernel(lo, hi)
                p = kern.program
                m = fused.get(p.name, 1)
                r = regs[prog.reg_slice(lo, hi)]
                bw, db = kern.tile(state.shape[2], bh, m)
                ms, plain_ms, err = timed_pair(
                    f"{p.name} {tuple(state.shape)} m={m} block {bh}x{bw}",
                    lambda: spd_multistep_streamed(
                        p, state, r, m=m, block_h=bh, block_w=bw,
                        double_buffer=db, out=buf),
                    lambda: spd_multistep_plain(p, state, r, m=m,
                                                block_h=bh, block_w=bw),
                    plain_iters=1)
                lib_ms = None
                if p.name == "AdvDiff_Program_f0_1":
                    # upwind advection is one linear stencil: a circular
                    # pad and a 3x3 convolution
                    vx, vy = r
                    wk = torch.tensor(
                        [[0, vy, 0], [vx, 1 - vx - vy, 0], [0, 0, 0]],
                        dtype=torch.float32, device="cuda").view(1, 1, 3, 3)
                    lib_ms, _ = cuda_ms(lambda: F.conv2d(
                        F.pad(state[None], (1, 1, 1, 1), mode="circular"),
                        wk))
                record(f"spd_multistep_streamed[{p.name}]",
                       "src/repro_torch/csrc/spd_stream.cuh",
                       "src/repro/kernels/spd_stream/streaming.py:180",
                       launches[p.name], ms, plain_ms,
                       2 * state.numel() * 4,
                       kern.compiled.hardware_report.flops * m
                       * state.shape[1] * state.shape[2], err, lib_ms)
        del buf
    del tstate, astate, singles
    torch.cuda.empty_cache()
    phase(f"  phase 8: {time.perf_counter() - t8:.1f} s")


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
    # phase 8's programs: every cluster core of both apps, built here
    psims = program_sims()
    clusters = cluster_programs(psims)
    stream_sources.update({f"spd_{name}": prog.cuda_source()
                           for name, prog in clusters.items()})
    build_s = build.build_all({
        **stream_sources, "flash_attention": build.flash_source(),
        "adamw": build.adamw_source(),
    })
    phase(f"  built {len(stream_sources) + 2} kernel libraries in "
          f"{build_s:.2f} s (nvcc in parallel)")
    flash_census(build)
    stream_census(build, stream_sources)
    hbm, fp32, bf16_peak = card_peaks()

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
    batched_launches(hbm, fp32)

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
        mesh_run(f"diffusion 8192^2 ({dy}, {dx})", big.kernel, dstate,
                 (0.2,), dy, dx, dif_single[None], 64, 4, 32, runs["dif"])
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

    lm = lm_serving(get_arch("qwen3-8b"), "phase 6", f32_layers=4,
                    resident=pipelined_prefill)
    # one group of six Mamba2 layers and the shared block, two tail layers
    hyb = lm_serving(get_arch("zamba2-7b"), "phase 6h", f32_layers=8)
    hybrid_f32_prefill()
    mix, kimi = moe_serving()
    whisper = whisper_serving()
    vlm = vlm_serving()
    dense = dense_serving()
    ssm_serving()

    # ---- 11. training (before phase 5, which times its kernel) -------
    ssm_training()
    dp_compression()
    train = dense_training()
    fam, fam_adamw = family_training()
    adamw = adamw_pass()
    mla = mla_training()

    # ---- 12. the dry run against the card ----------------------------
    dryrun_vs_card(card_line, lm[PREFILL]["wall"], train["step_s"])

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
    del f4, attr4, fbuf
    torch.cuda.empty_cache()

    # Flash attention at each launch shape of the LM phases (bf16), through
    # the dispatcher the models call: the Qwen3-8B prefill's (D 128, causal;
    # Mixtral's 4x2048 is the same launch), the Zamba2-7B shared block's
    # (D 112), Mixtral's 1x8192 with its window of 4096 binding, Kimi K2's
    # (D 112, GQA 8), whisper-medium's four (D 64: the encoder's and the
    # cross-attention's non-causal, the decoder's causal, the decode
    # step's cross-attention at Sq 1), LLaVA-NeXT-34B's (D 128, GQA 7) and
    # the Qwen3-8B training step's (B 2; its launches those of phase 11b).
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ops import attention

    train_bwd = train.pop("bwd")
    # The expert-parallel prefill (6e) launches the kernel at the same
    # shape as phase 6's 4x2048 prefill; its launches join that row.
    lm[PREFILL]["launches"] += mix["resident"]["launches"]
    flash_rows = (("flash_attention", lm[PREFILL]),
                  ("flash_attention[D 128, GQA 4, B 1, pipelined]",
                   lm["resident"]),
                  ("flash_attention[D 112]", hyb[PREFILL]),
                  ("flash_attention[D 128, window 4096]", mix[LONG_PREFILL]),
                  ("flash_attention[D 112, GQA 8]", kimi[PREFILL]),
                  ("flash_attention[D 64, whisper encoder]",
                   whisper["encoder self"]),
                  ("flash_attention[D 64, whisper cross]", whisper["cross"]),
                  ("flash_attention[D 64, whisper decoder]",
                   whisper["decoder self"]),
                  ("flash_attention[D 64, whisper decode cross]",
                   whisper["decode cross"]),
                  ("flash_attention[D 128, GQA 7]", vlm[VLM_PREFILL]),
                  ("flash_attention[D 128, GQA 4, training]", train),
                  ("flash_attention[D 128, MQA 48]",
                   dense["granite-34b"][PREFILL]),
                  ("flash_attention[D 128, GQA 6]",
                   dense["nemotron-4-15b"][PREFILL]),
                  ("flash_attention[D 128, GQA 5]",
                   dense["qwen2.5-32b"][PREFILL]),
                  *fam.items(),
                  ("flash_attention[D 192, Dv 128, MLA training]",
                   mla["fwd"]))
    for name, run in flash_rows:
        # Two layouts: contiguous (B, H, S, D), and the head-split views
        # of (B, S, H, D) buffers that the prefill passes (read in place).
        q, k, v = run.pop("qkv")
        window, causal = run["window"], run.get("causal", True)
        b_, hq_, sq_, d_ = q.shape
        sk_, dv_ = k.shape[2], v.shape[3]
        # 2 flop a column of Q K^T (D) and of P V (Dv); q, k, v and the
        # output (Dv) moved once
        ops = 2 * b_ * hq_ * (d_ + dv_) * kept_pairs(sq_, sk_, causal,
                                                     window)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + b_ * hq_ * sq_
                      * dv_)
        bound_ms = max(ops / bf16_peak, nbytes / hbm) * 1e3
        kw = dict(causal=causal, window=window)
        plain_ms, want = cuda_ms(
            lambda: flash_attention_plain(q, k, v, **kw), 2)
        views = tuple(x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (q, k, v))
        flash_errs = []
        label = (f"D {d_}" + (f", Dv {dv_}" if dv_ != d_ else "")
                 + f", Hq {hq_}, Hkv {k.shape[1]}, {b_}x{sq_}"
                 + (f"x{sk_}" if sk_ != sq_ else "")
                 + (f", window {window}" if window else "")
                 + ("" if causal else ", non-causal"))
        for layout, (qq, kk, vv) in (("contiguous", (q, k, v)),
                                     ("head-split views", views)):
            ms, got = cuda_ms(lambda: attention(qq, kk, vv, **kw), 20)
            flash_errs.append(check_close(
                f"flash {label} launch shape, {layout}, vs plain",
                got.float(), want.float(), FLASH_TOL["bfloat16"]))
            host = enqueue_ms(lambda: attention(qq, kk, vv, **kw))
            lib_ms, backend = sdpa_ms(qq, kk, vv, window, causal)
            phase(f"  flash {label} {layout}: {ms:.4f} ms (host enqueue "
                  f"{host:.4f} ms a call), "
                  f"{ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of "
                  f"the bound ({bound_ms:.4f} ms); SDPA {lib_ms:.4f} ms "
                  f"({ops / lib_ms / 1e9:.1f} TFLOP/s, {backend}); plain "
                  f"{plain_ms:.2f} ms")
        # The row holds the layout of the main path: the head-split views.
        record(name, "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:106",
               run["launches"], ms, plain_ms, nbytes, ops,
               max(run["errs"] + flash_errs), lib_ms, peak=bf16_peak)
        del q, k, v, views, want, got
        torch.cuda.empty_cache()
    del lm, hyb, mix, kimi, whisper, vlm, train, dense, fam, flash_rows
    # the backward kernel at the train cell's launch shape (phase 11b;
    # launches: 11b's steps under each remat policy); replaces no kernel
    record("flash_attention_bwd[D 128, GQA 4, training]",
           "src/repro_torch/csrc/flash_attention.cu",
           "none: the JAX package differentiates its chunked reference",
           train_bwd["launches"], train_bwd["ms"], train_bwd["plain_ms"],
           train_bwd["nbytes"], train_bwd["ops"], train_bwd["err"],
           train_bwd["library_ms"], peak=bf16_peak)
    # and at Kimi K2's MLA training shape (phase 11f; launches: its steps)
    mla_bwd = mla["bwd"]
    record("flash_attention_bwd[D 192, Dv 128, MLA training]",
           "src/repro_torch/csrc/flash_attention.cu",
           "none: the JAX package differentiates its chunked reference",
           mla_bwd["launches"], mla_bwd["ms"], mla_bwd["plain_ms"],
           mla_bwd["nbytes"], mla_bwd["ops"], mla_bwd["err"],
           mla_bwd["library_ms"], peak=bf16_peak)
    # phase 11e's fused AdamW pass, a step of the train cell's update
    # (launches: phase 11d's Mixtral steps, a step)
    record("adamw[mixtral-8x7b 2 layers, 23 parts, a step]",
           "src/repro_torch/csrc/adamw.cu",
           "none: the JAX package's AdamW is plain jnp",
           fam_adamw["mixtral-8x7b"], adamw["ms"], adamw["plain_ms"],
           adamw["nbytes"], adamw["ops"], adamw["err"], adamw["library_ms"])

    phase(f"  mesh runs: {json.dumps(mesh)}")
    dse_loop(kind, hbm, fp32)
    stream_programs(psims, hbm, record)
    sim_serving(record)
    paper_flow()
    phase(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
