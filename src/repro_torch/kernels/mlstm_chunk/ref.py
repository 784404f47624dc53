"""Plain PyTorch versions of the chunked mLSTM cell.

:func:`mlstm_chunk_plain` computes what ``repro/kernels/mlstm_chunk/kernel.py
::_mlstm_kernel`` computes: the chunked form in float32 throughout, from a
zero initial state, chunk by chunk (intra-chunk gated linear attention plus
the carried state's contribution, then the state update). It also returns
the final state ``(C, n, m)``, which decode continues from.
:func:`mlstm_recurrence_plain` is the step-by-step recurrence
(``repro/kernels/mlstm_chunk/ref.py::mlstm_ref``).

Two details keep the CUDA kernel's gate arithmetic equal to this one's on
the card: the log-sigmoid is written out as ``min(x, 0) - log1p(exp(-|x|))``
and the per-chunk cumulative sum adds left to right, as the kernel does.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["NEG_INF", "chunk_len", "log_sigmoid", "mlstm_chunk_terms", "mlstm_chunk_plain",
           "mlstm_recurrence_plain"]

NEG_INF = -1e30  # the stabilizer m of the zero state, and masked log-gates

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length L for a sequence of ``s``: min(chunk, s), which must
    divide ``s`` (the reference's rule)."""
    if s < 1:
        raise ValueError("empty sequence")
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {L}")
    return L


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x, torch.zeros_like(x)) - torch.log1p(torch.exp(-x.abs()))


def _cumsum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, added left to right."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for t in range(1, x.shape[-1]):
        acc = acc + x[..., t]
        out[..., t] = acc
    return out


def mlstm_chunk_terms(q, k, v, i_pre, f_pre, *, chunk: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """q/k/v: [BH, S, hd]; i_pre/f_pre: [BH, S] → (num [BH, S, hd], den
    [BH, S], (C [BH, hd, hd], n [BH, hd], m [BH])), all float32. The output
    is ``num / max(|den|, 1)``."""
    bh, s, hd = q.shape
    L = chunk_len(s, chunk)
    dev = q.device
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    ip = i_pre.to(torch.float32)
    fp = f_pre.to(torch.float32)
    C = torch.zeros(bh, hd, hd, dtype=torch.float32, device=dev)
    n = torch.zeros(bh, hd, dtype=torch.float32, device=dev)
    m = torch.full((bh,), NEG_INF, dtype=torch.float32, device=dev)
    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    nums, dens = [], []
    for c in range(s // L):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, ic = qf[:, sl], kf[:, sl], vf[:, sl], ip[:, sl]
        cumf = _cumsum_in_order(log_sigmoid(fp[:, sl]))            # [BH, L]
        D = cumf[:, :, None] - cumf[:, None, :] + ic[:, None, :]    # [BH, a, b]
        D = torch.where(causal, D, torch.full_like(D, NEG_INF))
        m_inter = cumf + m[:, None]
        m_i = torch.maximum(D.amax(dim=2), m_inter)
        w = torch.exp(D - m_i[:, :, None]) * (qc @ kc.transpose(1, 2))
        g = torch.exp(m_inter - m_i)
        nums.append(w @ vc + g[:, :, None] * (qc @ C))
        dens.append(w.sum(dim=2) + g * (qc @ n[:, :, None])[..., 0])
        last = cumf[:, -1]
        src = last[:, None] - cumf + ic
        m_new = torch.maximum(last + m, src.amax(dim=1))
        gdec = torch.exp(last + m - m_new)
        kg = kc * torch.exp(src - m_new[:, None])[:, :, None]
        C = C * gdec[:, None, None] + kg.transpose(1, 2) @ vc
        n = n * gdec[:, None] + kg.sum(dim=1)
        m = m_new
    return torch.cat(nums, dim=1), torch.cat(dens, dim=1), (C, n, m)


def mlstm_chunk_plain(q, k, v, i_pre, f_pre, *, chunk: int = 128
                      ) -> Tuple[torch.Tensor, State]:
    """q/k/v: [BH, S, hd] (bfloat16 or float32); gates [BH, S] → (y [BH, S,
    hd] in q's dtype, (C, n, m) in float32). S % min(chunk, S) == 0."""
    num, den, state = mlstm_chunk_terms(q, k, v, i_pre, f_pre, chunk=chunk)
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return y.to(q.dtype), state


def mlstm_recurrence_plain(q, k, v, i_pre, f_pre) -> Tuple[torch.Tensor, State]:
    """The exact recurrence, one step at a time, in float32 from the zero
    state: the same contract as :func:`mlstm_chunk_plain`."""
    bh, s, hd = q.shape
    dev = q.device
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    ip = i_pre.to(torch.float32)
    fp = f_pre.to(torch.float32)
    C = torch.zeros(bh, hd, hd, dtype=torch.float32, device=dev)
    n = torch.zeros(bh, hd, dtype=torch.float32, device=dev)
    m = torch.full((bh,), NEG_INF, dtype=torch.float32, device=dev)
    ys = []
    for t in range(s):
        logf = log_sigmoid(fp[:, t])
        m_new = torch.maximum(logf + m, ip[:, t])
        gdec = torch.exp(logf + m - m_new)
        gsrc = torch.exp(ip[:, t] - m_new)
        C = C * gdec[:, None, None] + gsrc[:, None, None] * (kf[:, t, :, None] * vf[:, t, None, :])
        n = n * gdec[:, None] + gsrc[:, None] * kf[:, t]
        num = (qf[:, t, None, :] @ C)[:, 0]
        den = (qf[:, t] * n).sum(dim=-1)
        ys.append(num / torch.clamp(den.abs(), min=1.0)[:, None])
        m = m_new
    return torch.stack(ys, dim=1).to(q.dtype), (C, n, m)
