"""Architecture configuration: the port's own copy of ``repro/configs/base.py``.

One :class:`ModelConfig` per architecture (see the sibling modules). Every
field is static metadata, field for field the reference's, so a config and
its analytic parameter count compare equal across the two packages. The
dry run's four cell shapes (:data:`SHAPES`) and their skip rule
(:func:`shape_applicable`) are the reference's too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["MoEConfig", "ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "register",
           "get_config", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention flavor
    qkv_bias: bool = False          # qwen1.5
    qk_norm: bool = False           # qwen3
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    moe: Optional[MoEConfig] = None
    # SSM / hybrid
    ssm_state: int = 0              # mamba2 d_state (zamba2) — 0 = no ssm
    ssm_expand: int = 2
    ssm_headdim: int = 64
    slstm_every: int = 0            # xlstm: every k-th block is sLSTM (0 = none)
    attn_every: int = 0             # zamba2: shared attention every k-th block
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500      # encoder input length (frontend stub)
    # vlm
    cross_attn_every: int = 0       # llama-3.2-vision: cross-attn layer period
    n_vision_tokens: int = 1601
    # numerics
    norm_eps: float = 1e-5
    # where the architecture comes from
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """May run the long_500k shape (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d

        def attn_params() -> int:
            return d * n_q + 2 * d * n_kv + n_q * d + (
                (n_q + 2 * n_kv) if self.qkv_bias else 0
            )

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # gated (SwiGLU): w1, w3, w2

        total = embed + head + 2 * d  # final norm (+pos stub)
        if self.family in ("dense", "vlm"):
            per = attn_params() + mlp_params(self.d_ff) + 2 * d
            total += self.n_layers * per
            if self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                total += n_cross * (attn_params() + 2 * d)
        elif self.family == "moe":
            m = self.moe
            assert m is not None
            per = attn_params() + 2 * d + d * m.n_experts  # router
            per += m.n_experts * 3 * d * m.d_ff_expert
            total += self.n_layers * per
        elif self.family == "encdec":
            per_enc = attn_params() + 2 * d * self.d_ff + 2 * d  # GELU mlp: w1,w2
            per_dec = 2 * attn_params() + 2 * d * self.d_ff + 3 * d
            total += self.n_encoder_layers * per_enc + self.n_layers * per_dec
        elif self.family == "ssm":  # xlstm
            d_in = 2 * d  # expanded mLSTM inner dim
            per = 2 * d * d_in + d_in * d + 3 * d * (d_in // 4) + 2 * d
            total += self.n_layers * per
        elif self.family == "hybrid":  # zamba2
            d_in = self.ssm_expand * d
            per_mamba = d * (2 * d_in) + d_in * d + d_in  # in/out proj + dt
            total += self.n_layers * per_mamba
            if self.attn_every:
                total += attn_params() + mlp_params(self.d_ff) + 2 * d  # shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        assert m is not None
        inactive = self.n_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the arch modules lazily so REGISTRY is populated
    from . import ALL_ARCHS  # noqa: F401

    if name not in REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell; the reason if it is
    skipped: long_500k is for sub-quadratic architectures only."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""
