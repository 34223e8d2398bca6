"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — SwiGLU with QKV bias (hf:Qwen/Qwen2.5)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
