"""Share of the traced window with nothing running on the card: on a mesh,
the mean over its cards of each card's idle share (``busy_s`` is the mean
of the cards' busy seconds)."""


def read(r):
    if r.kind != "run" or r.peaks is None or r.trace is None or r.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
