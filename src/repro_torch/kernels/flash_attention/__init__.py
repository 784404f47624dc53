"""Causal GQA flash attention: CUDA kernel (``csrc/``, :mod:`.kernel`), plain
PyTorch version (:mod:`.ref`) and model-layout wrapper (:mod:`.ops`)."""
