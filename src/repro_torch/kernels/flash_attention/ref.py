"""Plain PyTorch version of the flash attention kernel: exact softmax in
float32 (the same math as ``repro/kernels/flash_attention/ref.py::attention_ref``)."""

from __future__ import annotations

import torch

__all__ = ["attention_plain", "flash_bound", "NEG_INF", "BF16_STEP"]

NEG_INF = -1e30
BF16_STEP = 2.0 ** -7    # bfloat16 spacing relative to the bottom of a binade


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_start: int = 0) -> torch.Tensor:
    """q: [BKV, Sq, G, hd]; k, v: [BKV, Sk, hd] → [BKV, Sq, G, hd] in q's
    dtype. Causal masking compares absolute positions, the keys' counted
    from 0 and the queries' from ``q_start`` (a block of a longer
    sequence's rows)."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqgh,bkh->bqgk", qf, kf) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(q_start, q_start + sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bqgk,bkh->bqgh", p, vf).to(q.dtype)


def flash_bound(q, k, v, want, causal: bool, q_start: int = 0) -> torch.Tensor:
    """|Δ| allowed between the bfloat16 flash kernel and its plain version
    ``want`` on q, k, v (kernel layout). The kernel rounds each p to
    bfloat16 before PV (at most 2^-8 relative, bfloat16's unit roundoff)
    and sums the unrounded p into the denominator, as the plain version
    does, so their float32 outputs differ by at most 2^-8·A, A = Σ p|v| / Σ p
    (the plain version run on |v|), plus the float32 sums over Sk keys in
    two orders, each within Sk·2^-24·A. Both outputs round to bfloat16,
    each by at most half a step, which may put them one step (2^-7·|o|)
    apart. Bound: 2^-7·|plain| + (2^-8 + Sk·2^-23)·A + 1e-6, float32,
    shaped like q."""
    a = attention_plain(q.float(), k.float(), v.float().abs(), causal=causal, q_start=q_start)
    return (BF16_STEP * want.to(torch.float32).abs()
            + (2.0 ** -8 + k.shape[1] * 2.0 ** -23) * a + 1e-6)
