"""Share of the window's wall the engine spent inside its launches
(``SimEngine.stats()['launch_wall_s']``: the host's call of each launch,
which enqueues it on the stream and does not wait for the card)."""


def read(r):
    if r.kind != "serve":
        return None
    return 100.0 * r.engine["launch_wall_s"] / r.window_s
