"""Head-count window CNN: CUDA kernel (``csrc/``, :mod:`.kernel`), plain
PyTorch version (:mod:`.ref`) and wrapper (:mod:`.ops`)."""
