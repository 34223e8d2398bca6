"""Assigned-architecture configs (exact public numbers): copies of the JAX
package's ``configs/`` with a torch ``param_dtype`` (``base.py``), and
``kimi-k2-instruct``, Kimi K2 with its multi-head latent attention, and
``kimi-linear-48b-a3b``, Kimi Linear with Kimi Delta Attention, which the
port alone holds."""

from .base import (
    SHAPES,
    ArchConfig,
    LinearAttnConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)
from . import (
    granite_34b,
    kimi_k2_1t_a32b,
    kimi_k2_instruct,
    kimi_linear_48b_a3b,
    llava_next_34b,
    mixtral_8x7b,
    nemotron_4_15b,
    qwen2_5_32b,
    qwen3_8b,
    whisper_medium,
    xlstm_125m,
    zamba2_7b,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_34b,
        nemotron_4_15b,
        qwen2_5_32b,
        qwen3_8b,
        zamba2_7b,
        whisper_medium,
        xlstm_125m,
        mixtral_8x7b,
        kimi_k2_1t_a32b,
        llava_next_34b,
        kimi_k2_instruct,
        kimi_linear_48b_a3b,
    )
}


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key in ARCHS:
        return ARCHS[key]
    for k in ARCHS:
        if k.replace(".", "-").replace("_", "-") == key:
            return ARCHS[k]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = [
    "ARCHS",
    "ArchConfig",
    "LinearAttnConfig",
    "MoEConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "get_arch",
    "shape_applicable",
]
