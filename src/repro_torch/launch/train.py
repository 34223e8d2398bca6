"""Training launcher (the port of the JAX package's ``launch/train.py``).

Two modes:
* default — run a training job on one device through the port's loop:
  checkpoint/restart, injected faults, stragglers (docs/port.md §train);
* ``--plan-only`` — print the mesh plan the DSE planner recommends for the
  arch at a target chip count (the paper's design-space exploration as a
  deployment step).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --smoke --steps 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --steps 20 --batch 8 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-34b --plan-only --chips 256

``--smoke`` trains the reduced config; without it the published widths
and depth train (on the card). Weights are random, from seed 0.
Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory;
name one to resume a job.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.planner import ArchStats, plan, render_plans
from repro_torch.interop import param_tree, resolve_device
from repro_torch.models import registry
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, run_with_restarts
from repro_torch.train.optimizer import AdamWConfig, init_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced() config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--plan-only", action="store_true")
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.plan_only:
        shape = SHAPES["train_4k"]
        stats = ArchStats(
            name=cfg.name, params=cfg.num_params(),
            active_params=cfg.active_params(), n_layers=cfg.n_layers,
            d_model=cfg.d_model, global_batch=shape.global_batch,
            seq_len=shape.seq_len,
        )
        print(f"[train] mesh plans for {cfg.name} @ {args.chips} chips:")
        print(render_plans(plan(stats, args.chips), top=10))
        return None

    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"device {dev}")
    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps,
                          state_dtype=cfg.opt_state_dtype)
    opt_state = init_state(opt_cfg, param_tree(model))
    step = bundle.make_train_step(opt_cfg, args.microbatches)
    loop_cfg = LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir or tempfile.mkdtemp(prefix="repro-train-"),
        ckpt_every=args.ckpt_every, fail_at_steps=tuple(args.fail_at),
    )
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    _, _, st = run_with_restarts(loop_cfg, data_cfg, step, model, opt_state)
    span = (f"loss {st.losses[0]:.4f} -> {st.losses[-1]:.4f}" if st.losses
            else f"no step left to run in {loop_cfg.ckpt_dir}")
    print(f"[train] finished {st.step} steps "
          f"({st.restarts} restarts, {st.straggler_events} stragglers); "
          f"{span}")
    return st


if __name__ == "__main__":
    main()
