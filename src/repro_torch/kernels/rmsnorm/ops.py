"""Model-layout RMSNorm (any leading dims).

The counterpart of ``repro/kernels/rmsnorm/ops.py::rmsnorm``. Dispatch is on
x's device alone: on a card the kernel runs (or the call raises); on the CPU
the plain version runs. The kernel has no backward: on a card, with grad
mode on, a tensor that requires grad makes the call raise (its output would
carry no gradient); the loss runs the plain version instead.
"""

from __future__ import annotations

import torch

from .kernel import rmsnorm_rows_cuda
from .ref import rmsnorm_plain

__all__ = ["rmsnorm"]


def rmsnorm(x, w, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d] (a tensor, or numpy for the CPU); w: [d] → [..., d] in x's
    dtype, on x's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    if not x.is_cuda:
        return rmsnorm_plain(x, w, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rmsnorm: the CUDA kernel has no backward; a tensor requires "
                           "grad (run the plain version, models.common.PLAIN)")
    return rmsnorm_rows_cuda(x.contiguous(), w.contiguous(), eps)
