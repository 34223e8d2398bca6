"""repro_torch: the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The first slice carries the paper's main path down to running Hopper
kernels: SPD text is parsed (core.spd) into a DFG (core.dfg), compiled
(core.compiler, core.library), lowered to a generated temporal-blocking
stream kernel (core.codegen, kernels.spd_stream) under a legal plan
(core.legalize), and checked against the diffusion and D2Q9 LBM apps,
whose hand-written kernel is kernels.lbm_stream; core.distribute runs it
over a device mesh. The LM serving slice (configs, models, serve, launch)
runs Qwen3-8B's prefill through the hand-written flash-attention kernel
(kernels.flash_attention) and serves it with the continuous-batching
engine (docs/port.md §lm). Entry points run on the card unless given
``device="cpu"``, where each kernel's plain torch version runs instead
(docs/port.md §slice).

Nothing here imports JAX or the ``repro`` package.
"""

__version__ = "0.1.0"
