"""Card-seconds launched under the attention's backward (the host
operation ``trace_ops["attention_backward"]`` names: the autograd
engine's ``FlashAttentionFnBackward``, the plain recompute) over the
cards × the traced window."""


def read(r):
    if r.kind != "train" or r.peaks is None or r.trace is None:
        return None
    sec = r.trace.get("device_s_under", {}).get("attention_backward", 0.0)
    if sec <= 0 or r.trace["window_s"] <= 0:
        return None
    return 100.0 * sec / (r.devices * r.trace["window_s"])
