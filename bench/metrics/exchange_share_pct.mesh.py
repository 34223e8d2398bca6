"""Card-seconds of device copies in a mesh run (peer and device-to-device
memcpys, PyTorch's ``direct_copy`` kernels) over the cards × the traced
window: the halo exchange between shards and the per-simulation cut and
gather of the state."""

COPIES = ("Memcpy PtoP", "Memcpy DtoD", "direct_copy")


def read(r):
    if (r.kind != "run" or r.peaks is None or r.trace is None
            or r.plan.get("d", 1) == 1 or r.trace["window_s"] <= 0):
        return None
    sec = sum(s for k, (_, s) in r.trace["kernels"].items()
              if any(c in k for c in COPIES))
    if sec <= 0:
        return None
    return 100.0 * sec / (r.devices * r.trace["window_s"])
