"""Share of the window's wall the engine's ticks spent on the host outside
the launches and the dissolutions: admission, context lookup, cohort
formation and the tick's bookkeeping (``SimEngine.stats()``: ``tick_s``
less ``launch_wall_s`` and ``dissolve_s``)."""


def read(r):
    e = r.engine
    if r.kind != "serve" or "tick_s" not in e or "dissolve_s" not in e:
        return None
    return 100.0 * (e["tick_s"] - e["launch_wall_s"] - e["dissolve_s"]) \
        / r.window_s
