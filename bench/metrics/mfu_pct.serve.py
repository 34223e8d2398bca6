"""Serving engine's share of the FP32 peak: frozen flops per update × the
member steps its launches advanced in the window × H·W, over the window."""

from bench.roofline import mfu_pct


def read(r):
    if r.kind != "serve" or r.peaks is None:
        return None
    return mfu_pct(r.frozen, r.peaks, r.engine["member_steps"] * r.cells,
                   r.window_s)
