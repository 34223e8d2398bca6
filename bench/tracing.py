"""Reduction of a ``torch.profiler`` trace to the benchmark's device numbers.

The harness marks its measured window with the span ``bench.window`` and
the host's work inside it with spans of its own (``run_for_point``,
``engine.step``, ``submit``, ``wait_arrival``, ``check``). From the raw
kineto events this module takes:

- ``busy_s``: for each card the run used, the union of its activity
  intervals (kernels, copies, fills) inside the window, and the mean of
  those over the cards (``busy_s_per_device`` keeps each), so that
  ``busy_s / window_s`` stays a share of the window; the profiler's
  device-side copies of the harness's spans are annotations, not
  activity, and are left out;
- ``kernels``: device seconds and launches by kernel name, summed over
  the cards (card-seconds);
- ``idle_gaps``: each card's stretches of the window with nothing on it,
  labelled by what the host was doing there (the harness span open at
  the gap's middle, and the innermost host operation open there), summed
  by label over the cards and divided by their count, so that they add
  up with ``busy_s`` to the window;
- ``device_s_under``: for each name of ``ops`` (``{name: substring}``,
  a configuration's ``frozen`` ``trace_ops``), the card-seconds of the
  device activity launched while a host operation whose name holds the
  substring was open. A device event is joined to its runtime call
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, …) by the profiler's
  correlation id, and credited where that call started (the device-side
  copies of host annotations are not device activity here).

With one card every number is that card's.
"""

from __future__ import annotations

import bisect

WINDOW = "bench.window"
SPANS = ("run_for_point", "engine.step", "submit", "wait_arrival", "explore",
         "check", "train.step")


def short_name(name: str) -> str:
    """A kernel's name without its parameter list or ``void``; an
    anonymous namespace reads ``{anonymous namespace}``, so that its
    parenthesis does not end the name."""
    name = name.replace("(anonymous namespace)", "{anonymous namespace}")
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


def _gaps(busy, w0, w1):
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def _under(events, w0, w1, ops) -> dict:
    """``device_s_under`` of :func:`reduce_events`."""
    launched, open_at, host = {}, {key: [] for key in ops}, set()
    for name, dev, s, e, *rest in events:
        if dev:
            continue
        host.add(name)
        if len(rest) > 1 and rest[1] and name.startswith("cu"):
            launched[rest[1]] = s  # a runtime or driver call
        for key, sub in ops.items():
            if sub in name:
                open_at[key].append((s, e))
    out = {}
    for key, spans in open_at.items():
        spans = _merge(spans)  # nested calls of one name count once
        starts = [s for s, _ in spans]
        sec = 0.0
        for name, dev, s, e, *rest in events:
            t = launched.get(rest[1]) if dev and len(rest) > 1 else None
            # a device event named as a host one is the device-side copy
            # of an annotation, which may carry a launch's correlation id
            if t is None or e <= w0 or s >= w1 or name in host:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][1] >= t:
                sec += (min(e, w1) - max(s, w0)) / 1e9
        out[key] = sec
    return out


def reduce_events(events, devices=None, ops=None) -> dict | None:
    """``events``: ``(name, on_device, start_ns, end_ns[, card[, corr]])``
    tuples, ``card`` the index of a device event's card (0 where left
    out), ``corr`` the profiler's correlation id joining a device event to
    the host's runtime call that launched it (0 where none).
    ``devices``: the indices of the cards the run used (default: the cards
    with events, or card 0); a card with nothing in the window is idle all
    through it. ``ops``: ``{name: substring}`` of host operations to
    credit device time to (``device_s_under``, returned only where ``ops``
    is given). Returns the window's numbers, or None when no window span
    was recorded."""
    win = [(ev[2], ev[3]) for ev in events if not ev[1] and ev[0] == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    by_card: dict[int, list] = {}
    host, spans = [], []
    kernels: dict[str, list] = {}
    for name, dev, s, e, *rest in events:
        if e <= w0 or s >= w1:
            continue
        if dev:
            if name in SPANS or name == WINDOW:
                continue  # the device-side copy of a host span
            s, e = max(s, w0), min(e, w1)
            by_card.setdefault(rest[0] if rest else 0, []).append((s, e))
            k = kernels.setdefault(short_name(name), [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e9
        elif name in SPANS:
            spans.append((s, e, name))
        elif name != WINDOW:
            host.append((s, e, name))
    cards = list(devices) if devices is not None else sorted(by_card) or [0]
    spans.sort()
    host.sort()
    span_starts = [s for s, _, _ in spans]
    host_starts = [s for s, _, _ in host]
    labelled: dict[str, float] = {}
    busy_s = []
    for card in cards:
        busy = _merge(by_card.get(card, []))
        busy_s.append(sum(e - s for s, e in busy) / 1e9)
        for g0, g1 in _gaps(busy, w0, w1):
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
            labelled[label] = (labelled.get(label, 0.0)
                               + (g1 - g0) / 1e9 / len(cards))
    out = {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(busy_s) / len(cards),
        "busy_s_per_device": busy_s,
        "kernels": {k: (n, sec) for k, (n, sec) in kernels.items()},
        "idle_gaps": sorted(labelled.items(), key=lambda kv: -kv[1]),
    }
    if ops is not None:
        out["device_s_under"] = _under(events, w0, w1, ops)
    return out


def reduce_profile(prof, devices=None, ops=None) -> dict | None:
    """:func:`reduce_events` over a finished ``torch.profiler.profile``;
    ``devices``: the indices of the cards the run used; ``ops`` as
    there."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        events.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                       s + e.duration_ns(), e.device_index(),
                       e.correlation_id()))
    return reduce_events(events, devices, ops)


def breakdown(reduced: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten largest sums of idle gaps by host activity."""
    ops = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1][1])
    return {
        "device_ops": [[name, sec] for name, (_, sec) in ops[:10]],
        "idle_gaps": [[name, sec] for name, sec in reduced["idle_gaps"][:10]],
    }
