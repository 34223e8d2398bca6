"""kimi-k2-1t-a32b [moe]: a GQA stand-in of Kimi K2 that mirrors the JAX
package's config: 61L d_model=7168 64H (GQA kv=8, head dim 112) expert
d_ff=2048 vocab=163840, 384 experts top-8 by softmax + 1 shared expert,
first layer dense — not the published attention, which is multi-head
latent attention with sigmoid routing: ``kimi-k2-instruct``
(``kimi_k2_instruct.py``). bf16 optimizer states keep the 512-chip dry-run
inside 16 GiB/chip (DESIGN.md §Arch-notes)."""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    activation="swiglu",
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                  moe_start_layer=1, capacity_factor=1.25),
    opt_state_dtype="bfloat16",
    notes="384 experts / 16-way model axis = 24 experts per slice (EP)",
)
