"""Model-layout RMSNorm (any leading dims).

The counterpart of ``repro/kernels/rmsnorm/ops.py::rmsnorm``. Dispatch is on
the device alone: on a CUDA device the kernel runs (or the call raises); on
the CPU the plain version runs.
"""

from __future__ import annotations

import torch

from ...device import resolve_device
from .kernel import rmsnorm_rows_cuda
from .ref import rmsnorm_plain

__all__ = ["rmsnorm"]


def rmsnorm(x, w, eps: float = 1e-5, *, device="cuda") -> torch.Tensor:
    """x: [..., d]; w: [d] → [..., d] in x's dtype, on ``device``."""
    # The model's call passes a card's tensor and that card: no conversion.
    if not (isinstance(x, torch.Tensor) and x.is_cuda and x.device == device):
        dev = resolve_device(device)
        x = torch.as_tensor(x, device=dev)
        if dev.type != "cuda":
            return rmsnorm_plain(x, torch.as_tensor(w, dtype=torch.float32, device=dev), eps)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    return rmsnorm_rows_cuda(x.contiguous(), w.contiguous(), eps)
