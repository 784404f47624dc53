"""Model-layout chunked mLSTM cell.

The counterpart of ``repro/kernels/mlstm_chunk/ops.py::mlstm_cell``: it folds
the model's ``[B, S, H, hd]`` layout into the kernel's ``[B·H, S, hd]`` and
back, and also returns the final state, which decode continues from.
Dispatch is on q's device alone: on a card the kernel runs (or the call
raises); on the CPU the plain version runs. The kernel has no backward: on a
card, with grad mode on, a tensor that requires grad makes the call raise
(its outputs would carry no gradient); the loss runs the plain version
instead.
"""

from __future__ import annotations

import torch

from .kernel import mlstm_chunk_bh_cuda
from .ref import mlstm_chunk_plain

__all__ = ["mlstm_cell", "in_model_layout", "fold", "unfold"]


def fold(a: torch.Tensor) -> torch.Tensor:
    """[B, S, H, ...] → [B·H, S, ...], contiguous."""
    b, s, h = a.shape[:3]
    return a.transpose(1, 2).reshape(b * h, s, *a.shape[3:]).contiguous()


def unfold(a: torch.Tensor, b: int) -> torch.Tensor:
    """[B·H, S, ...] → [B, S, H, ...]."""
    return a.reshape(b, a.shape[0] // b, *a.shape[1:]).transpose(1, 2)


def in_model_layout(run, q, k, v, i_pre, f_pre, *, chunk: int = 128):
    """``run`` (the kernel's wrapper or its plain version, [B·H, S, ...]
    layout) applied to model-layout tensors → (y [B, S, H, hd], (C [B, H,
    hd, hd], n [B, H, hd], m [B, H]))."""
    b, _, h, hd = q.shape
    y, (C, n, m) = run(*(fold(t) for t in (q, k, v, i_pre, f_pre)), chunk=chunk)
    return unfold(y, b), (C.reshape(b, h, hd, hd), n.reshape(b, h, hd), m.reshape(b, h))


def mlstm_cell(q, k, v, i_pre, f_pre, *, chunk: int = 128):
    """q/k/v: [B, S, H, hd]; gates [B, S, H], all on q's device (tensors, or
    numpy for the CPU) → (y [B, S, H, hd] in q's dtype, (C [B, H, hd, hd],
    n [B, H, hd], m [B, H]) float32), on q's device, from the zero state."""
    q, k, v = (torch.as_tensor(t) for t in (q, k, v))
    i_pre, f_pre = (torch.as_tensor(t, dtype=torch.float32, device=q.device)
                    for t in (i_pre, f_pre))
    if q.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_pre, f_pre)):
        raise RuntimeError("mlstm_cell: the CUDA kernel has no backward; a tensor requires "
                           "grad (run the plain version, models.common.PLAIN)")
    run = mlstm_chunk_bh_cuda if q.is_cuda else mlstm_chunk_plain
    return in_model_layout(run, q, k, v, i_pre, f_pre, chunk=chunk)
