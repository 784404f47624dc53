"""Granite-3.0-1B-A400M — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=256, moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64),
    source="smoke",
)
