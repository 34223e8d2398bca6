"""The stream kernel's share of its roofline in a serve cell: the bound of
the engine's launches in the window (its occupancy and member-step
counters) over the device time of ``spd_multistep_kernel`` in the trace."""

from bench.roofline import bound_s

KERNEL = "spd_multistep_kernel"


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    sec = sum(s for k, (_, s) in r.trace["kernels"].items() if KERNEL in k)
    if sec <= 0:
        return None
    members = sum(int(w) * n for w, n in r.engine["occupancy"].items())
    bound = bound_s(r.frozen, r.peaks, r.cells, members=members,
                    member_steps=r.engine["member_steps"])
    return 100.0 * bound / sec
