"""Whisper-large-v3 — enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

Backbone only: the conv frontend is a stub. ``models.api.extra_inputs``
gives the shape of its precomputed frame embeddings (1500 × d_model); serving
feeds zeros of that shape, as ``repro`` does.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, n_audio_frames=1500,
    source="arXiv:2212.04356",
))

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, n_audio_frames=16, source="smoke",
)
