"""Temporal parallelism the plan reached: lattice updates over H·W, per
launch of the stream kernel (``StripeProgram.launches`` of the core, which
counts each shard's launch: over the mesh's d, 1 on one card)."""


def read(r):
    if r.kind != "run" or not r.launches:
        return None
    return r.updates / r.cells / (r.launches / r.plan.get("d", 1))
