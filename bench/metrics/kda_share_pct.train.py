"""Card-seconds launched under Kimi Delta Attention's delta rule (the host
operations ``trace_ops["kda"]`` names: the autograd Function ``KDAFn``,
its forward and remat recompute, and its backward ``KDAFnBackward``)
over the cards × the traced window. Nothing to read in a configuration
without that entry, or where nothing ran under it."""


def read(r):
    if (r.kind != "train" or r.peaks is None or r.trace is None
            or "kda" not in r.frozen.get("trace_ops", {})):
        return None
    sec = r.trace.get("device_s_under", {}).get("kda", 0.0)
    if sec <= 0 or r.trace["window_s"] <= 0:
        return None
    return 100.0 * sec / (r.devices * r.trace["window_s"])
