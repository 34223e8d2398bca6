"""Whole training step's share of the bf16 peak of the cards it used: the
configuration's frozen model flops a step (forward and backward, no
recompute, no capacity padding) × the window's steps, over its
host-clock seconds and over ``devices`` × one card's 989 TFLOP/s."""

from bench.roofline import bf16_share_pct


def read(r):
    if r.kind != "train" or r.peaks is None or r.steps == 0:
        return None
    return bf16_share_pct(r.frozen["model_flops_per_step"] * r.steps,
                          r.window_s, r.peaks, r.devices)
