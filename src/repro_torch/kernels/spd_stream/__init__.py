"""Launches of the generated SPD stream kernels (docs/port.md §tile):
the periodic :func:`spd_multistep` / :func:`spd_multistep_streamed` and
their per-shard twins :func:`spd_multistep_halo` /
:func:`spd_multistep_halo_streamed` (docs/port.md §distribute)."""

from .ops import (
    spd_multistep,
    spd_multistep_halo,
    spd_multistep_halo_streamed,
    spd_multistep_streamed,
    stream_run_blocked,
)

__all__ = [
    "spd_multistep",
    "spd_multistep_halo",
    "spd_multistep_halo_streamed",
    "spd_multistep_streamed",
    "stream_run_blocked",
]
