"""Distribution on a logical mesh: sharding rules and hints, the
expert-parallel MoE dispatch, pipeline parallelism and gradient
compression (the port of the JAX package's ``parallel/``,
docs/port.md §parallel)."""
