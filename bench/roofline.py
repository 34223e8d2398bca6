"""Peaks of the card and the operations and bytes of a stream launch; the
share of the bf16 peak that a training cell's frozen flops make.

The counts are frozen in each configuration's file (``frozen``): flops per
lattice update from the core's census, and the state planes each launch
reads and writes once per batch member. A launch of m fused steps on a
``B × H × W`` grid needs at least ``(planes_read + planes_written) · B · H
· W · bytes_per_word`` bytes of HBM traffic and ``flops_per_update · m · B
· H · W`` operations; its bound is the larger of the two over the card's
peaks.
"""

from __future__ import annotations

#: Published dense peaks (NVIDIA H100 SXM data sheet, no sparsity) at the
#: card's full 700 W power limit.
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12,
             "bf16_flops_per_s": 989e12},
}


def peaks_for(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    raise KeyError(f"no peaks for the card {kind!r}")


def launch_bytes(frozen: dict, cells: int, members: int = 1) -> float:
    return float((frozen["planes_read"] + frozen["planes_written"])
                 * frozen["bytes_per_word"] * cells * members)


def launch_flops(frozen: dict, cells: int, member_steps: int) -> float:
    """Operations of ``member_steps`` fused steps summed over members."""
    return float(frozen["flops_per_update"] * cells * member_steps)


def bound_s(frozen: dict, peaks: dict, cells: int, *, members: int,
            member_steps: int) -> float:
    """Least seconds of launches that move ``members`` member round trips
    and compute ``member_steps`` member steps: the larger of the bytes
    over HBM bandwidth and the flops over the FP32 peak. Summed over
    launches that differ in m or width it is a lower bound of the sum of
    their own bounds (equal when one term binds every launch)."""
    return max(launch_bytes(frozen, cells, members)
               / peaks["hbm_bytes_per_s"],
               launch_flops(frozen, cells, member_steps)
               / peaks["fp32_flops_per_s"])


def mfu_pct(frozen: dict, peaks: dict, updates: int, seconds: float) -> float:
    """Share of the FP32 peak that ``updates`` lattice updates in
    ``seconds`` of wall clock make."""
    return (100.0 * frozen["flops_per_update"] * updates / seconds
            / peaks["fp32_flops_per_s"])


def bf16_share_pct(flops: float, seconds: float, peaks: dict,
                   devices: int = 1) -> float:
    """Share of ``devices`` cards' bf16 peak that ``flops`` operations in
    ``seconds`` make: a training step's model flops over the window, or a
    kernel's over its device time."""
    return 100.0 * flops / seconds / (devices * peaks["bf16_flops_per_s"])
