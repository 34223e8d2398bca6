"""Share of the window's wall the engine's host spent blocked on the card
(``SimEngine.stats()['wait_s']``: before a dissolution's ``.cpu()``, a
live timing or a host state's copy). An engine without the counter yields
no number."""


def read(r):
    if r.kind != "serve" or "wait_s" not in r.engine:
        return None
    return 100.0 * r.engine["wait_s"] / r.window_s
