"""Burst checkpoints of the training state (``repro/checkpoint``)."""
