"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, slstm_every=8,
    source="arXiv:2405.04517",
))

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab=256, slstm_every=2, source="smoke",
)
