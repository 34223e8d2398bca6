"""CUDA-event timing of kernel variants side by side (``variants.py``
beside each kernel). On the machine with the card only."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def ms_of(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ms_rounds(runs: dict, *, rounds: int = 3, iters: int = 20,
              warmup: int = 2) -> dict:
    """``{name: [ms per round]}``: every run warmed up (``warmup × iters``
    calls, the card to its steady clocks), then ``rounds`` rounds, every
    second one in reverse order, so a drift in the card's clocks shows as
    a difference between rounds."""
    for fn in runs.values():
        ms_of(fn, warmup * iters)
    times = {name: [] for name in runs}
    order = list(runs)
    for i in range(rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            times[name].append(ms_of(runs[name], iters))
    return times
