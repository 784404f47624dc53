"""Qwen3-4B — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
))

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab=256, head_dim=16, qk_norm=True, source="smoke",
)
