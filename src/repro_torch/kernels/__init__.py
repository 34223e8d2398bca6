"""Hand-written Hopper kernels (CUDA C++ for sm_90a, sources in ``csrc/``):

* ``spd_stream`` — the generated temporal-blocking stream kernel that
  ``repro_torch.core.codegen`` prints from any compiled SPD core, in a
  declarative and a streamed (persistent, prefetching) launch;
* ``lbm_stream`` — the hand-written fused m-step D2Q9 LBM kernel;
* ``flash_attention`` — the hand-written blocked online-softmax attention
  kernel that the LM prefill runs in every layer;
* ``adamw`` — the fused AdamW pass of the training step: the gradients'
  global norm and the update of every parameter in place.

Each module keeps its kernel's plain torch version beside the wrapper and
counts launches on the wrapper (``fn.launches``); ``build`` compiles the
sources with ``nvcc`` on first use (docs/port.md §build).
"""
