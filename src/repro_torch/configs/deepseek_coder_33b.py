"""DeepSeek-Coder-33B — llama-arch [arXiv:2401.14196; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256, source="arXiv:2401.14196",
))

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab=256, source="smoke",
)
