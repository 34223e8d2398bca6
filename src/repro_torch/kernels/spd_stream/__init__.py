"""Launches of the generated SPD stream kernels (docs/port.md §tile)."""

from .ops import spd_multistep, spd_multistep_streamed, stream_run_blocked

__all__ = ["spd_multistep", "spd_multistep_streamed", "stream_run_blocked"]
