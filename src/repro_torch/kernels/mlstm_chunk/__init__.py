"""Chunked mLSTM cell: CUDA kernel (``csrc/``, :mod:`.kernel`), plain PyTorch
version (:mod:`.ref`) and wrapper (:mod:`.ops`)."""
