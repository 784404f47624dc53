"""Plain PyTorch version of the fused RMSNorm (the same math as
``repro/kernels/rmsnorm/ref.py::rmsnorm_ref``)."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_plain"]


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; w: [d] → like x. Mean of squares, ``rsqrt``, scaling by
    the weight, all in float32; the result is cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(x.dtype)
