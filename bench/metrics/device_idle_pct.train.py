"""Share of a training cell's traced window with nothing running on the
card (the mean over the cards used of each one's idle share)."""


def read(r):
    if (r.kind != "train" or r.peaks is None or r.trace is None
            or r.trace["window_s"] <= 0):
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
