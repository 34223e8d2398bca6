"""Train a language model end to end on the PyTorch port with the
production loop: deterministic data pipeline, AdamW, async checkpointing,
fault injection, straggler tracking. Any assigned arch is selectable; by
default a ~100M-param qwen3 variant.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300       # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --arch xlstm-125m --smoke --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --steps 50 --fail-at 20

The port of ``examples/train_lm.py``; it imports torch and
``repro_torch``, never JAX.
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.interop import param_tree, resolve_device
from repro_torch.models import registry
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, run_with_restarts
from repro_torch.train.optimizer import AdamWConfig, init_state


def hundred_m_config():
    """~100M-parameter decoder (qwen3 family), f32."""
    base = get_arch("qwen3-8b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=32768, head_dim=64, dtype="float32",
    )


def main(argv=None):
    """Train; returns the loop's ``LoopState``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="assigned arch id; default the 100M qwen3 variant")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced() smoke config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one); name one to resume")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject faults after these steps (restart demo)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = get_arch(args.arch)
        cfg = cfg.reduced() if args.smoke else cfg
    else:
        cfg = hundred_m_config()
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params~{cfg.num_params()/1e6:.1f}M "
          f"family={cfg.family} device={dev}")

    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20,
                          total_steps=args.steps,
                          state_dtype=cfg.opt_state_dtype)
    opt_state = init_state(opt_cfg, param_tree(model))
    step = bundle.make_train_step(opt_cfg, args.microbatches)
    loop_cfg = LoopConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir or tempfile.mkdtemp(prefix="repro-lm-"),
        ckpt_every=50, log_every=10, fail_at_steps=tuple(args.fail_at),
    )
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    _, _, st = run_with_restarts(loop_cfg, data_cfg, step, model, opt_state)
    print(f"[train] done: {st.step} steps, {st.restarts} restarts, "
          f"{st.straggler_events} straggler events")
    print(f"[train] loss first5={['%.3f' % l for l in st.losses[:5]]} "
          f"last5={['%.3f' % l for l in st.losses[-5:]]}")
    return st


if __name__ == "__main__":
    main()
