"""Zamba2-7B — Mamba2 blocks + shared attention [arXiv:2411.15242; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_expand=2, ssm_headdim=64, attn_every=6,
    source="arXiv:2411.15242",
))

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab=256, ssm_state=16, ssm_expand=2, ssm_headdim=16, attn_every=2,
    source="smoke",
)
