"""whisper-medium [audio]: 24L(enc)+24L(dec) d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865 — encoder-decoder; conv frontend STUBBED to
precomputed frame embeddings per the assignment (arXiv:2212.04356).
seq_len = encoder frames; decoder length = seq_len/4 (DESIGN.md §Shapes).
RoPE replaces learned/sinusoidal positions (same shapes/FLOPs)."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    activation="gelu",
    enc_dec=True,
)
