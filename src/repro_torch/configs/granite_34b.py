"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — GPT-BigCode/llama lineage code model (arXiv:2405.04324).
GELU 2-matrix MLP + MQA reproduce the ~34B parameter count."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    activation="gelu",
    notes="MQA (kv=1): KV projections replicate under TP (128-wide)",
)
