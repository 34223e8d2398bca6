"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention 4096
(arXiv:2401.04088). SWA bounds the KV cache -> runs the long_500k cell."""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    activation="swiglu",
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336),
    supports_long_context=True,
    notes="8 experts < 16-way model axis: TP-within-expert sharding",
)
