"""Model-layout chunked mLSTM cell.

The counterpart of ``repro/kernels/mlstm_chunk/ops.py::mlstm_cell``: it folds
the model's ``[B, S, H, hd]`` layout into the kernel's ``[B·H, S, hd]`` and
back, and also returns the final state, which decode continues from.
Dispatch is on q's device alone: on a card the kernel runs (or the call
raises); on the CPU the plain version runs. The kernel has no backward: on a
card, with grad mode on, a tensor that requires grad makes the call raise
(its outputs would carry no gradient); the loss runs the plain version
instead.

:func:`work` is one call's work (``kernels/counted.py``), :func:`split_work`
its operations by the rate the bfloat16 kernel runs them at, and
:func:`mlstm_cell_counted` the stand-in that adds the work to a count on
``meta``.
"""

from __future__ import annotations

import torch

from ..counted import Work, add_work
from .kernel import mlstm_chunk_bh_cuda
from .ref import chunk_len, mlstm_chunk_plain

__all__ = ["mlstm_cell", "in_model_layout", "fold", "unfold", "work", "split_work",
           "mlstm_cell_counted"]


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


def work(bh: int, s: int, hd: int, chunk: int, elt: int) -> Work:
    """One call on B·H ``bh`` sequences of ``s`` (q, k, v, y in elements of
    ``elt`` bytes).

    ``flops``: the plain version's products per chunk of L, q·kᵀ and W·v
    (2·L²·hd each), q·C and the C update (2·L·hd² each) and q·n (2·L·hd).
    ``bytes``: q, k, v and the float32 gates read once, y and the float32
    (C, n, m) written once. ``ops``: what the data needs, per chunk the C
    update (2·L·hd²), q·C where C is not zero (2·L·hd² past the first
    chunk), the causal halves of q·kᵀ and W·v (2·2·L(L+1)/2·hd), and q·n
    and the n update (2·2·L·hd)."""
    L = chunk_len(s, chunk)
    nc = s // L
    nbytes = 4 * bh * s * hd * elt + 2 * bh * s * 4 + bh * (hd * hd + hd + 1) * 4
    per_chunk = 2 * L * hd * hd + 2 * L * (L + 1) * hd + 4 * L * hd
    ops = bh * (nc * per_chunk + (nc - 1) * 2 * L * hd * hd)
    flops = bh * nc * (4 * L * L * hd + 4 * L * hd * hd + 2 * L * hd)
    return Work(flops=flops, bytes=nbytes, ops=ops)


def split_work(bh: int, s: int, hd: int, chunk: int):
    """The bfloat16 kernel's operations of :func:`work` by the rate they can
    run at: (products of a float32 operand, three bf16 passes on the tensor
    cores: the C update, q·C past the first chunk and W·v; q·kᵀ, exact in
    one pass; q·n and the n update, on the CUDA cores)."""
    L = chunk_len(s, chunk)
    nc = s // L
    split = bh * (nc * 2 * L * hd * hd + (nc - 1) * 2 * L * hd * hd + nc * L * (L + 1) * hd)
    return split, bh * nc * L * (L + 1) * hd, bh * nc * 4 * L * hd


def mlstm_cell_counted(q, k, v, i_pre, f_pre, *, chunk: int = 128):
    """The kernel's stand-in on ``meta``: adds :func:`work` to the open
    count and returns empty outputs of :func:`mlstm_cell`'s shapes and
    types, through the wrapper's own layout copies."""
    b, s, h, hd = q.shape
    i_pre, f_pre = (t.to(torch.float32) for t in (i_pre, f_pre))
    add_work("mlstm_chunk", (q, k, v, i_pre, f_pre),
             work(b * h, s, hd, chunk, q.element_size()))

    def run(qf, kf, vf, i, f, chunk):
        chunk_len(qf.shape[1], chunk)
        n = qf.shape[0]
        f32 = dict(dtype=torch.float32, device=qf.device)
        return torch.empty_like(qf), (torch.empty(n, hd, hd, **f32),
                                      torch.empty(n, hd, **f32), torch.empty(n, **f32))

    return in_model_layout(run, q, k, v, i_pre, f_pre, chunk=chunk)
