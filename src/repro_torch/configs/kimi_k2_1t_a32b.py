"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, 384 experts top-8 + 1 shared expert, first layer dense —
trillion-parameter MoE (paper-table config). bf16 optimizer states keep the
512-chip dry-run inside 16 GiB/chip (DESIGN.md §Arch-notes)."""

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
