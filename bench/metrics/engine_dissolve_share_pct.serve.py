"""Share of the window's wall the engine spent dissolving cohorts: the
``.cpu()`` of the stacked state, its host buffer included, and the
completions (``SimEngine.stats()['dissolve_s']``)."""


def read(r):
    if r.kind != "serve" or "dissolve_s" not in r.engine:
        return None
    return 100.0 * r.engine["dissolve_s"] / r.window_s
