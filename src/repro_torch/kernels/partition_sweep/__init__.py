"""CSR column sweep + burst DP: CUDA kernel (``csrc/``, :mod:`.kernel`),
plain PyTorch version (:mod:`.ref`) and host wrapper (:mod:`.ops`)."""
