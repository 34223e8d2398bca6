"""Serve a small model with batched requests through the port's
continuous-batching engine (KV-cache decode path).

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 8 --max-batch 4
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port of ``examples/serve_lm.py``, with the same flags, the same
reduced config and the same prompts (``np.random.default_rng(0)``), and
weights from a seeded ``torch.Generator``; ``--device`` defaults to the
card. It imports torch and ``repro_torch``, never JAX.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.interop import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    """Serve; returns the completions by request id, the prompts, the
    bundle and the model."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_arch(args.arch).reduced(), n_layers=4, d_model=256, vocab=4096,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
    )
    bundle = registry.build(cfg, device=dev)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(bundle, model, max_batch=args.max_batch,
                      max_seq=args.max_seq)

    rng = np.random.default_rng(0)
    prompts = {}
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, size=rng.integers(4, 12)).tolist()
        prompts[rid] = prompt
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.new_tokens,
                           temperature=args.temperature))
    done = eng.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    for c in sorted(done, key=lambda c: c.rid):
        print(f"[serve] req {c.rid}: {c.tokens}")
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens/dt:.1f} tok/s, "
          f"batch slots={args.max_batch}, {dev.type})")
    return {"completions": {c.rid: c.tokens for c in done},
            "prompts": prompts, "bundle": bundle, "model": model}


if __name__ == "__main__":
    main()
