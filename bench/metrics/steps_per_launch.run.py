"""Temporal parallelism the plan reached: lattice updates over H·W, per
launch of the stream kernel (``StripeProgram.launches`` of the core)."""


def read(r):
    if r.kind != "run" or not r.launches:
        return None
    return r.updates / r.cells / r.launches
