"""Llama-3.2-11B-Vision — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Backbone only: the vision tower is a stub. ``models.api.extra_inputs`` gives
the shape of its precomputed patch embeddings (n_vision_tokens × d_model);
serving feeds zeros of that shape, as ``repro`` does.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, cross_attn_every=5, n_vision_tokens=1601, rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab=256, cross_attn_every=2, n_vision_tokens=17, source="smoke",
)
