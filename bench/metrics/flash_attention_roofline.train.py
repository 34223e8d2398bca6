"""The flash-attention kernel's share of its roofline in a training step:
its launches (kernels whose name, namespaces aside, starts with
``flash_kernel``: ``hopper::flash_kernel<128>``) ×
the configuration's frozen ``flash_flops_per_launch`` (4·D flops per kept
(query, key) pair and head), over one card's bf16 peak, over the
launches' device seconds. Every launch is one layer's forward, in the
step's forward or in its remat recompute."""

from bench.roofline import bf16_share_pct

KERNEL = "flash_kernel"


def read(r):
    if r.kind != "train" or r.peaks is None or r.trace is None:
        return None
    hits = [(n, sec) for k, (n, sec) in r.trace["kernels"].items()
            if k.rsplit("::", 1)[-1].startswith(KERNEL)]
    n, sec = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if n == 0 or sec <= 0:
        return None
    return bf16_share_pct(n * r.frozen["flash_flops_per_launch"], sec,
                          r.peaks)
