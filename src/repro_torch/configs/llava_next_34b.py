"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend STUBBED to 2880 precomputed patch
embeddings per the assignment (hf:llava-hf/llava-v1.6)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    activation="swiglu",
    n_frontend_tokens=2880,
)
