"""Recompute of the plan a run launched: the cell-steps its launches
executed, halo rows and guard columns of each launch tile included, over
the updates it kept (the ``plan.executed_cell_steps`` and
``plan.useful_cell_steps`` counters of ``repro_torch.tracing``, added once
a simulation and per shard). 1 is no recompute."""


def read(r):
    if r.kind != "run":
        return None
    try:
        from repro_torch.tracing import snapshot
    except ImportError:
        return None
    counts = snapshot()
    useful = counts.get("plan.useful_cell_steps")
    if not useful:
        return None
    return counts["plan.executed_cell_steps"] / useful
