"""Serving launcher: stand up the continuous-batching engine for an arch
(the port of the JAX package's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --device cpu                       # reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --full
                                         # the published config, on the card

The reduced config is the default, as in the reference; ``--full`` serves
the published widths and depth. Weights are random, from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.interop import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config, not the reduced one")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    print(f"[serve] {cfg.name} ({'full' if args.full else 'reduced'}: "
          f"{cfg.num_params()/1e6:.1f}M) slots={args.max_batch} "
          f"cache={args.max_seq} device={dev}")
    bundle = registry.build(cfg, device=dev)
    params = bundle.init(torch.Generator(dev).manual_seed(args.seed))
    eng = ServeEngine(bundle, params, max_batch=args.max_batch,
                      max_seq=args.max_seq, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, rng.integers(4, 16)).tolist()
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.new_tokens,
                           temperature=args.temperature))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done)
    print(f"[serve] {len(done)} completions, {n_tok} tokens, "
          f"{n_tok/dt:.1f} tok/s, {eng.decode_calls} decode steps")
    return done


if __name__ == "__main__":
    main()
