"""Whole run's share of the FP32 peak of the cards it used: frozen flops
per update × the lattice updates of the window, over the window's
host-clock seconds and over ``devices`` × one card's peak."""

from bench.roofline import mfu_pct


def read(r):
    if r.kind != "run" or r.peaks is None:
        return None
    return mfu_pct(r.frozen, r.peaks, r.updates, r.window_s) / r.devices
