"""Nearest-rank p95 of the latencies of the requests due in the window,
each from its due time on the open-loop schedule to its retirement."""


def read(r):
    if r.kind != "serve" or not r.latency:
        return None
    return r.latency["p95_ms"]
