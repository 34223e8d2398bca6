"""Share of the window's wall the engine spent inside its launches
(``SimEngine.stats()['launch_wall_s']``, each launch synchronized)."""


def read(r):
    if r.kind != "serve":
        return None
    return 100.0 * r.engine["launch_wall_s"] / r.window_s
