"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — mLSTM blocks
with one sLSTM every 6th block (arXiv:2405.04517). d_ff=0: blocks carry
their own up/down projections, no separate FFN. O(1) recurrent decode ->
runs the long_500k cell."""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm=SSMConfig(chunk=128),
    block_pattern=(),  # default: sLSTM at every 6th position
    supports_long_context=True,
)
