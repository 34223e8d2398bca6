"""Nearest-rank p50 of the latencies of the requests due in the window,
each from its due time on the open-loop schedule to its retirement."""


def read(r):
    if r.kind != "serve" or not r.latency:
        return None
    return r.latency["p50_ms"]
