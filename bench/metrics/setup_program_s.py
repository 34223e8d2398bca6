"""Host seconds of the program's own set-up in the process: the SPD parse,
compile and lowering, the DSE sweep, and the kernels' ``nvcc`` runs and
library loads (the ``setup.*`` counters of ``repro_torch.tracing``, each
less the phases timed inside it)."""


def read(r):
    try:
        from repro_torch.tracing import snapshot
    except ImportError:
        return None
    parts = [v for k, v in snapshot().items() if k.startswith("setup.")]
    return sum(parts) if parts else None
