"""The stream kernel's share of its roofline in a run cell: the launches'
bound over their device time (``spd_multistep_kernel`` in the trace, on
every card: card-seconds). Every launch of the window is one member at
the plan's m over the cells its shard owns: H·W over the mesh's d (1 on
one card), against one card's peaks."""

from bench.roofline import bound_s

KERNEL = "spd_multistep_kernel"


def read(r):
    if r.kind != "run" or r.trace is None:
        return None
    n = sum(c for k, (c, _) in r.trace["kernels"].items() if KERNEL in k)
    sec = sum(s for k, (_, s) in r.trace["kernels"].items() if KERNEL in k)
    if n == 0 or sec <= 0:
        return None
    per = bound_s(r.frozen, r.peaks, r.cells // r.plan.get("d", 1),
                  members=1, member_steps=r.plan["m"])
    return 100.0 * n * per / sec
