"""Host microseconds a launch spent enqueueing the kernel: from the call
into the kernel to its return, before the synchronize
(``SimEngine.stats()['enqueue_s']`` over ``launches``)."""


def read(r):
    if r.kind != "serve" or "enqueue_s" not in r.engine or \
            not r.engine.get("launches"):
        return None
    return 1e6 * r.engine["enqueue_s"] / r.engine["launches"]
