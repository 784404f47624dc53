"""Model-layout RMSNorm (any leading dims).

The counterpart of ``repro/kernels/rmsnorm/ops.py::rmsnorm``. Dispatch is on
x's device alone: on a card the kernel runs (or the call raises); on the CPU
the plain version runs. The kernel has no backward: on a card, with grad
mode on, a tensor that requires grad makes the call raise (its output would
carry no gradient); the loss runs the plain version instead.

:func:`work` is one call's work (``kernels/counted.py``), and
:func:`rmsnorm_counted` the stand-in that adds it to a count on ``meta``.
"""

from __future__ import annotations

import torch

from ..counted import Work, add_work
from .kernel import rmsnorm_rows_cuda
from .ref import rmsnorm_plain

__all__ = ["rmsnorm", "work", "rmsnorm_counted"]


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


def work(rows: int, d: int, elt: int) -> Work:
    """One call on ``rows`` rows of ``d`` in elements of ``elt`` bytes: no
    product; x read and y written once, the float32 weight read once; four
    float32 operations an element (square, sum, scale, weight)."""
    return Work(flops=0, bytes=2 * rows * d * elt + 4 * d, ops=4 * rows * d)


def rmsnorm_counted(x, w, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's stand-in on ``meta``: adds :func:`work` to the open
    count and returns an empty tensor like x."""
    d = x.shape[-1]
    add_work("rmsnorm", (x, w), work(x.numel() // d, d, x.element_size()))
    return torch.empty_like(x.contiguous())
