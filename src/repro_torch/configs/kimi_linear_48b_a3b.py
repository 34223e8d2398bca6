"""kimi-linear-48b-a3b [moe]: Kimi Linear at its published widths
(moonshotai/Kimi-Linear-48B-A3B-Instruct, config.json; the Kimi Linear
report, arXiv:2510.26692): 27L d_model=2304, three of every four layers
Kimi Delta Attention (32 heads of 128, short convolutions of 4; 1-based
kda_layers 1-3, 5-7, ..., 25-26), the others multi-head latent attention
without rotary embedding (full_attn_layers 4, 8, ..., 24, 27; 32 heads,
no query latent, kv_lora_rank 512, q/k 128 + 64, v 128); the first layer
dense (SwiGLU 9216), then 256 SwiGLU experts of 1024, top-8 by sigmoid
score with a selection bias, the gates renormalised and scaled by 2.446,
and 1 shared expert; RMSNorm epsilon 1e-5. A configuration of the port
alone. Training only: neither KDA nor MLA has a decode path here
(docs/port.md §kda)."""

from .base import ArchConfig, LinearAttnConfig, MoEConfig

KDA_LAYERS = tuple(i for i in range(1, 27) if i % 4)

CONFIG = ArchConfig(
    name="kimi-linear-48b-a3b",
    family="moe",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    d_ff=9216,
    vocab=163840,
    activation="swiglu",
    use_rope=False,
    q_rank=0,
    kv_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    linear=LinearAttnConfig(n_heads=32, head_dim=128, conv=4,
                            kda_layers=KDA_LAYERS,
                            full_attn_layers=(4, 8, 12, 16, 20, 24, 27)),
    norm_eps=1e-5,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=1024, n_shared=1,
                  moe_start_layer=1, capacity_factor=1.25,
                  score_func="sigmoid", route_scale=2.446),
    notes="256 experts over 32 cards of expert parallelism: 8 a card",
)
