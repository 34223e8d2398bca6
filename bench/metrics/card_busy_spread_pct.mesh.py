"""The busiest card's busy seconds less the least busy card's, over the
traced window: the slowest card sets the pace of every exchange, and the
first card alone cuts and gathers the state and runs the check."""


def read(r):
    if (r.kind != "run" or r.peaks is None or r.trace is None
            or r.plan.get("d", 1) == 1 or r.trace["window_s"] <= 0):
        return None
    busy = r.trace["busy_s_per_device"]
    if len(busy) < 2:
        return None
    return 100.0 * (max(busy) - min(busy)) / r.trace["window_s"]
