"""Architecture configs of the port, one module per architecture.

Only the architectures whose model family the port runs are registered:
qwen3-4b (dense) and xlstm-1.3b (ssm). The other eight of ``repro.configs``
follow with their families (ROADMAP.md, queue 1).
"""

from . import qwen3_4b, xlstm_1_3b
from .base import REGISTRY, ModelConfig, get_config

ALL_ARCHS = sorted(REGISTRY)

SMOKE_CONFIGS = {
    "qwen3-4b": qwen3_4b.SMOKE,
    "xlstm-1.3b": xlstm_1_3b.SMOKE,
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
