"""The port's host spans and set-up counters (docs/port.md §serve).

:func:`span` names a stretch of host work in a ``torch.profiler`` trace.
With no profiler active it returns one shared null context, so an
untraced run pays a flag check; under an active ``torch.profiler.profile``
it opens a host range with the cheapest recorder this torch has
(``_RecordFunctionFast``, else ``record_function``). The ranges land in
the profiler's own trace, on the clock of the device's events, so
whoever profiles the port sees its phases beside the kernels.

Rules for a span: its name starts with ``sim.``, ``spd.``, ``stream.`` or
``setup.``, and it encloses at most one device operation. The profiler
may give a range that encloses device work a device-side copy spanning
that work (``record_function`` ranges get one); over one operation the
copy covers exactly that operation, so the device's busy time read from
the trace does not change.

The counters are one plain dict for the process: :func:`add` adds to a
counter, :func:`snapshot` copies them, and :func:`timed` opens
:func:`span` and adds its host seconds to the counter of the same name.
``builds`` counts ``nvcc`` runs; ``plan.executed_cell_steps`` and
``plan.useful_cell_steps`` the cell-steps a run's launches execute and
keep at the plan it runs (``core.codegen.count_plan``, once a run).
"""

from __future__ import annotations

import contextlib
from time import perf_counter

import torch
import torch.autograd.profiler as _profiler

__all__ = ["add", "snapshot", "span", "timed"]

_NULL = contextlib.nullcontext()
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function

_COUNTERS: dict[str, float] = {"builds": 0}


def span(name: str):
    """A host range named ``name`` while a profiler records, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return _RECORD(name)
    return _NULL


def add(name: str, value: float) -> None:
    """Add ``value`` (seconds, or a count) to the counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def snapshot() -> dict:
    """The process's counters: ``setup.*`` seconds, ``builds`` and
    ``plan.*`` cell-steps."""
    return dict(_COUNTERS)


@contextlib.contextmanager
def timed(name: str):
    """:func:`span` ``name``, its host seconds added to the counter
    ``name``; also a decorator. The set-up phases do not nest, so the
    counters sum to the wall of the phases."""
    t0 = perf_counter()
    try:
        with span(name):
            yield
    finally:
        add(name, perf_counter() - t0)
