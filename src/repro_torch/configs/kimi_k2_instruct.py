"""kimi-k2-instruct [moe]: Kimi K2 at its published widths (moonshotai/
Kimi-K2-Instruct, config.json): 61L d_model=7168, 64 heads of multi-head
latent attention (q_lora_rank 1536, kv_lora_rank 512, qk_nope 128 +
qk_rope 64 = 192 for q and k, v 128), vocab=163840, rope theta 50000;
the first layer dense (SwiGLU 18432), then 384 SwiGLU experts of 2048,
top-8 by sigmoid score with a selection bias, the gates renormalised and
scaled by 2.827, and 1 shared expert of 2048 (DeepSeek-V3's block).
A configuration of the port alone; its GQA stand-in mirroring the JAX
package is kimi-k2-1t-a32b. Training only: MLA has no decode path here
(docs/port.md §mla)."""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-instruct",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=64,
    d_ff=18432,
    vocab=163840,
    head_dim=192,
    activation="swiglu",
    rope_theta=50_000.0,
    q_rank=1536,
    kv_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                  moe_start_layer=1, capacity_factor=1.25,
                  score_func="sigmoid", route_scale=2.827),
    notes="384 experts over 48 cards of expert parallelism: 8 a card",
)
