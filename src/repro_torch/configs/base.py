"""Architecture config schema + the assigned input-shape suite.

The port of the JAX package's ``configs/base.py``: the same dataclasses and
analytic parameter counts, with ``param_dtype`` a ``torch.dtype``. The
hybrid and SSM counts walk the port's own ``Zamba2`` and ``XLSTM``
modules, built on the meta device (nothing is allocated), as the
reference walks its parameter tree through ``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    n_shared: int = 0  # shared-expert multiplier (kimi-style)
    capacity_factor: float = 1.25
    moe_start_layer: int = 0  # dense layers before the MoE stack
    # routing: "softmax" over the experts, or "sigmoid" scores chosen by
    # the top k of score + a per-expert selection bias (DeepSeek-V3's
    # noaux_tc); either way the k gates are renormalised, then scaled
    score_func: str = "softmax"
    route_scale: float = 1.0
    # the held slice: this card computes experts [held_start, held_start +
    # n_held) of the router's n_experts (expert parallelism's shard, its
    # exchange left out); 0 holds every expert
    n_held: int = 0
    held_start: int = 0

    @property
    def held(self) -> int:
        """The number of experts this card computes."""
        return self.n_held or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclass(frozen=True)
class LinearAttnConfig:
    """Kimi Delta Attention (models/kda.py) beside full attention: heads
    of ``head_dim`` for q, k and v, causal short convolutions of width
    ``conv``, and the published 1-based layer pattern."""

    n_heads: int
    head_dim: int
    conv: int = 4
    kda_layers: tuple = ()
    full_attn_layers: tuple = ()


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    sliding_window: int = 0
    # multi-head latent attention (DeepSeek-V2 §2.1.2-2.1.3) where kv_rank
    # > 0: q and k of qk_nope_dim + qk_rope_dim (which head_dim states), v
    # of v_head_dim, through the low-rank latents q_rank and kv_rank
    # (models/layers.py: MLA)
    q_rank: int = 0
    kv_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # Kimi Delta Attention in the layers ``linear.kda_layers`` names, the
    # config's attention (MLA here) in the others
    linear: LinearAttnConfig | None = None
    norm_eps: float = 1e-6  # every RMSNorm's epsilon
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_period: int = 0  # hybrid: shared attn block every k SSM layers
    block_pattern: tuple = ()  # ssm family: 'mlstm' / 'slstm' per layer
    enc_dec: bool = False  # audio: encoder-decoder
    n_frontend_tokens: int = 0  # vlm: stubbed patch embeddings
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # long_500k policy (DESIGN.md §Shape-policy): sub-quadratic decode only
    supports_long_context: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.kv_rank:  # MLA's q and k heads, whatever the file says
            object.__setattr__(self, "head_dim",
                               self.qk_nope_dim + self.qk_rope_dim)
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.linear and sorted(self.linear.kda_layers
                                  + self.linear.full_attn_layers) != list(
                                      range(1, self.n_layers + 1)):
            raise ValueError(f"{self.name}: kda_layers and full_attn_layers "
                             f"must split layers 1..{self.n_layers}")

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def mla(self) -> bool:
        """Whether the attention is multi-head latent attention."""
        return self.kv_rank > 0

    def is_kda(self, i: int) -> bool:
        """Whether layer ``i`` (0-based) is Kimi Delta Attention."""
        return self.linear is not None and i + 1 in self.linear.kda_layers

    # ---- analytic parameter counts (drive the planner + roofline) --------
    def kda_params(self) -> int:
        """One KDA layer: q, k, v and their convolutions, the decay's
        low-rank pair, ``A_log`` and ``dt_bias``, β, the output gate's
        pair, the per-head norm and the output projection."""
        la, d = self.linear, self.d_model
        w = la.n_heads * la.head_dim
        return (3 * d * w + 3 * la.conv * w + la.n_heads
                + 2 * (d * la.head_dim + la.head_dim * w) + w
                + d * la.n_heads + la.head_dim + w * d)

    def attn_params(self) -> int:
        if self.mla:
            d, h, rq, rkv = (self.d_model, self.n_heads, self.q_rank,
                             self.kv_rank)
            qk = h * (self.qk_nope_dim + self.qk_rope_dim)
            return ((d * rq + rq + rq * qk if rq else d * qk)
                    + d * (rkv + self.qk_rope_dim) + rkv
                    + rkv * h * (self.qk_nope_dim + self.v_head_dim)
                    + h * self.v_head_dim * d)
        hd = self.head_dim
        p = self.d_model * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.qkv_bias:
            p += hd * (self.n_heads + 2 * self.n_kv_heads)
        return p

    def mlp_params(self, d_ff: int | None = None) -> int:
        f = d_ff if d_ff is not None else self.d_ff
        mult = 3 if self.activation == "swiglu" else 2
        return mult * self.d_model * f

    def layer_params(self, moe_layer: bool | None = None,
                     kda: bool = False) -> int:
        moe_layer = (self.moe is not None) if moe_layer is None else moe_layer
        p = ((self.kda_params() if kda else self.attn_params())
             + 2 * self.d_model)  # norms
        if moe_layer and self.moe:
            p += self.moe.held * 3 * self.d_model * self.moe.d_ff
            p += self.d_model * self.moe.n_experts  # router
            if self.moe.score_func == "sigmoid":
                p += self.moe.n_experts  # selection bias
            if self.moe.n_shared:
                p += self.mlp_params(self.moe.d_ff * self.moe.n_shared)
        else:
            p += self.mlp_params()
        return p

    def num_params(self) -> float:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.family in ("hybrid", "ssm"):
            # non-transformer blocks: count the real module once (meta
            # tensors: no allocation) and cache on the instance, as the
            # reference does
            cached = getattr(self, "_np_cache", None)
            if cached is None:
                from repro_torch.models.registry import XLSTM
                from repro_torch.models.zamba2 import Zamba2

                cls = Zamba2 if self.family == "hybrid" else XLSTM
                model = cls(self, device=torch.device("meta"))
                cached = float(sum(p.numel() for p in model.parameters()))
                object.__setattr__(self, "_np_cache", cached)
            return cached
        if self.enc_dec:
            enc = self.attn_params() + self.mlp_params() + 2 * self.d_model
            dec = 2 * self.attn_params() + self.mlp_params() + 3 * self.d_model
            return float(self.n_layers * (enc + dec) + emb)
        n_dense = self.moe.moe_start_layer if self.moe else self.n_layers
        return float(sum(self.layer_params(i >= n_dense, self.is_kda(i))
                         for i in range(self.n_layers)) + emb)

    def active_params(self) -> float:
        """Per-token active parameters (MoE activates top_k of n_experts)."""
        if not self.moe:
            return self.num_params()
        ffn = (self.moe.top_k * 3 * self.d_model * self.moe.d_ff
               + (self.mlp_params(self.moe.d_ff * self.moe.n_shared)
                  if self.moe.n_shared else 0))
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return float(sum(
            (self.kda_params() if self.is_kda(i) else self.attn_params())
            + 2 * self.d_model + ffn for i in range(self.n_layers)) + emb)

    # ---- reduced config for CPU smoke tests -------------------------------
    def reduced(self) -> "ArchConfig":
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_period else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=256,
            vocab=512,
            head_dim=32,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window
            else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            dtype="float32",
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff=128,
                n_shared=min(self.moe.n_shared, 1),
                moe_start_layer=min(self.moe.moe_start_layer, 1),
                # ample capacity: smoke tests assert prefill==decode, so no
                # token may drop on either path
                capacity_factor=8.0,
            )
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state=16, head_dim=16, chunk=16
            )
        if self.attn_period:
            changes["attn_period"] = 2
        if self.block_pattern:
            changes["block_pattern"] = tuple(self.block_pattern[:2]) or (
                "mlstm", "slstm",
            )
        if self.n_kv_heads == self.n_heads:  # keep MHA archs MHA
            changes["n_kv_heads"] = changes["n_heads"]
        if self.mla:  # latents and heads of every width, q/k at head_dim
            changes.update(q_rank=64 if self.q_rank else 0, kv_rank=32,
                           qk_nope_dim=24, qk_rope_dim=8, v_head_dim=16)
        if self.linear:  # a KDA layer, then a full-attention one
            changes["linear"] = dataclasses.replace(
                self.linear, n_heads=2, head_dim=16, kda_layers=(1,),
                full_attn_layers=(2,))
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """DESIGN.md shape policy: which (arch x shape) cells run."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k dense-KV decode skipped"
    if shape.kind == "decode" and cfg.linear:
        return False, ("Kimi Delta Attention has no decode path "
                       "(its recurrent state cache is not ported)")
    if shape.kind == "decode" and cfg.mla:
        return False, ("multi-head latent attention has no decode path "
                       "(an absorbed latent cache is not ported)")
    return True, ""
