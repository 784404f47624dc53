"""Qwen1.5-0.5B — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B",
))

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab=256, qkv_bias=True, tie_embeddings=True, source="smoke",
)
