"""Reduction of a ``torch.profiler`` trace to the benchmark's device numbers.

The harness marks its measured window with the span ``bench.window`` and
the host's work inside it with spans of its own (``run_for_point``,
``engine.step``, ``submit``, ``wait_arrival``, ``check``). From the raw
kineto events this module takes:

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills) inside the window; the profiler's device-side copies of
  the harness's spans are annotations, not activity, and are left out;
- ``kernels``: device seconds and launches by kernel name;
- ``idle_gaps``: the window's stretches with nothing on the device,
  summed by what the host was doing there: the harness span open at the
  gap's middle, and the innermost host operation open there.
"""

from __future__ import annotations

import bisect

WINDOW = "bench.window"
SPANS = ("run_for_point", "engine.step", "submit", "wait_arrival", "explore",
         "check")


def short_name(name: str) -> str:
    """A kernel's name without its parameter list or ``void``."""
    name = name.split("(", 1)[0].strip()
    return name[5:] if name.startswith("void ") else name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict | None:
    """``events``: ``(name, on_device, start_ns, end_ns)`` tuples. Returns
    the window's numbers, or None when no window span was recorded."""
    win = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    device, host, spans = [], [], []
    kernels: dict[str, list] = {}
    for name, dev, s, e in events:
        if e <= w0 or s >= w1:
            continue
        if dev:
            if name in SPANS or name == WINDOW:
                continue  # the device-side copy of a host span
            s, e = max(s, w0), min(e, w1)
            device.append((s, e))
            k = kernels.setdefault(short_name(name), [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e9
        elif name in SPANS:
            spans.append((s, e, name))
        elif name != WINDOW:
            host.append((s, e, name))
    busy = _merge(device)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    spans.sort()
    host.sort()
    span_starts = [s for s, _, _ in spans]
    host_starts = [s for s, _, _ in host]
    labelled: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "no span"
        i = bisect.bisect_right(span_starts, mid) - 1
        if i >= 0 and spans[i][1] >= mid:
            label = spans[i][2]
        j = bisect.bisect_right(host_starts, mid) - 1
        for k in range(j, max(j - 256, -1), -1):
            if host[k][1] >= mid:
                label += "/" + host[k][2]
                break
        labelled[label] = labelled.get(label, 0.0) + (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": {k: (n, sec) for k, (n, sec) in kernels.items()},
        "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1]),
    }


def reduce_profile(prof) -> dict | None:
    """:func:`reduce_events` over a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        events.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                       s + e.duration_ns()))
    return reduce_events(events)


def breakdown(reduced: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten largest sums of idle gaps by host activity."""
    ops = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1][1])
    return {
        "device_ops": [[name, sec] for name, (_, sec) in ops[:10]],
        "idle_gaps": [[name, sec] for name, sec in reduced["idle_gaps"][:10]],
    }
