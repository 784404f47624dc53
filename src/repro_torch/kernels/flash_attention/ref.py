"""Plain PyTorch version of the flash attention kernel: exact softmax in
float32 (the same math as ``repro/kernels/flash_attention/ref.py::attention_ref``)."""

from __future__ import annotations

import torch

__all__ = ["attention_plain", "NEG_INF"]

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [BKV, Sq, G, hd]; k, v: [BKV, Sk, hd] → [BKV, Sq, G, hd] in q's
    dtype. Causal masking compares absolute positions counted from 0 on both
    sides."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqgh,bkh->bqgk", qf, kf) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bqgk,bkh->bqgh", p, vf).to(q.dtype)
