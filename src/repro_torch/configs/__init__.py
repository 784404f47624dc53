"""Architecture configs of the port, one module per architecture.

All ten of ``repro.configs``' architectures are registered: the dense
(qwen3-4b, tinyllama-1.1b, deepseek-coder-33b, qwen1.5-0.5b), moe
(granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b), vlm (llama-3.2-vision-11b),
encdec (whisper-large-v3), ssm (xlstm-1.3b) and hybrid (zamba2-7b)
families.
"""

from . import (
    deepseek_coder_33b,
    granite_moe_1b,
    llama3_2_vision_11b,
    phi3_5_moe,
    qwen1_5_0_5b,
    qwen3_4b,
    tinyllama_1_1b,
    whisper_large_v3,
    xlstm_1_3b,
    zamba2_7b,
)
from .base import REGISTRY, ModelConfig, get_config

ALL_ARCHS = sorted(REGISTRY)

SMOKE_CONFIGS = {
    "qwen3-4b": qwen3_4b.SMOKE,
    "xlstm-1.3b": xlstm_1_3b.SMOKE,
    "tinyllama-1.1b": tinyllama_1_1b.SMOKE,
    "deepseek-coder-33b": deepseek_coder_33b.SMOKE,
    "qwen1.5-0.5b": qwen1_5_0_5b.SMOKE,
    "granite-moe-1b-a400m": granite_moe_1b.SMOKE,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe.SMOKE,
    "llama-3.2-vision-11b": llama3_2_vision_11b.SMOKE,
    "whisper-large-v3": whisper_large_v3.SMOKE,
    "zamba2-7b": zamba2_7b.SMOKE,
}


def resolve_config(cfg, smoke: bool = False) -> ModelConfig:
    """(config-or-arch-name, smoke) → :class:`ModelConfig`.

    A ready :class:`ModelConfig` passes through untouched; an arch name is
    resolved against the smoke registry when ``smoke``.
    """
    if isinstance(cfg, ModelConfig):
        return cfg
    if not isinstance(cfg, str):
        raise TypeError(
            f"expected a ModelConfig or arch name, got {type(cfg).__name__}"
        )
    if smoke:
        try:
            return SMOKE_CONFIGS[cfg]
        except KeyError:
            raise KeyError(
                f"unknown smoke arch {cfg!r}; known: {sorted(SMOKE_CONFIGS)}"
            ) from None
    return get_config(cfg)
