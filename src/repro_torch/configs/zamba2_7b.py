"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32, MHA) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + one weight-tied shared
attention block applied every 6 SSM layers (arXiv:2411.15242).
Sub-quadratic decode -> runs the long_500k cell."""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    activation="swiglu",
    ssm=SSMConfig(state=64, head_dim=64, expand=2, conv=4, chunk=128,
                  n_groups=1),
    attn_period=6,
    supports_long_context=True,
    notes="shared attn block: per-site LoRA deltas omitted (DESIGN.md)",
)
