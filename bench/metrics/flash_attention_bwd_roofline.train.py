"""The flash-attention backward's share of its roofline in a training
step: its calls (launches of kernels whose name, namespaces aside, starts
with ``flash_bwd_dkdv_kernel``: one a call) × the configuration's frozen
``flash_bwd_flops_per_call`` (the five products' 2·(3·D + 2·Dv) flops per
kept (query, key) pair and head), over one card's bf16 peak, over the
device seconds of every kernel whose name starts with ``flash_bwd_`` (the
call's three launches). Nothing to read in a configuration without that
count, or where no backward kernel ran."""

from bench.roofline import bf16_share_pct

CALL = "flash_bwd_dkdv_kernel"
PREFIX = "flash_bwd_"


def read(r):
    if (r.kind != "train" or r.peaks is None or r.trace is None
            or "flash_bwd_flops_per_call" not in r.frozen):
        return None
    calls, sec = 0, 0.0
    for k, (n, s) in r.trace["kernels"].items():
        name = k.rsplit("::", 1)[-1]
        if name.startswith(PREFIX):
            sec += s
            if name.startswith(CALL):
                calls += n
    if calls == 0 or sec <= 0:
        return None
    return bf16_share_pct(calls * r.frozen["flash_bwd_flops_per_call"], sec,
                          r.peaks)
