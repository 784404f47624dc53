"""Model-layout flash attention.

The counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``:
it regroups the model's ``[B, S, H, hd]`` / ``[B, S, KV, hd]`` layout into
the kernel's ``[B·KV, S, G, hd]`` / ``[B·KV, S, hd]`` and back, with
positions counted from 0 (what prefill uses). Dispatch is on q's device
alone: on a card the kernel runs (or the call raises); on the CPU the plain
version runs. The kernel has no backward: on a card, with grad mode on, a
tensor that requires grad makes the call raise (its output would carry no
gradient); the loss runs the plain version instead.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_bkv_cuda
from .ref import attention_plain

__all__ = ["flash_attention", "to_bkv", "from_bkv"]


def to_bkv(q, k, v):
    """[B, Sq, H, hd], [B, Sk, KV, hd] ×2 → [B·KV, Sq, G, hd], [B·KV, Sk, hd] ×2."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd).transpose(1, 2).reshape(b * kv, sq, h // kv, hd)
    kg = k.transpose(1, 2).reshape(b * kv, sk, hd)
    vg = v.transpose(1, 2).reshape(b * kv, sk, hd)
    return qg.contiguous(), kg.contiguous(), vg.contiguous()


def from_bkv(o, b: int):
    """[B·KV, Sq, G, hd] → [B, Sq, KV·G, hd]."""
    bkv, sq, g, hd = o.shape
    kv = bkv // b
    return o.reshape(b, kv, sq, g, hd).transpose(1, 2).reshape(b, sq, kv * g, hd)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] on q's device (tensors, or
    numpy for the CPU) → [B, Sq, H, hd] in q's dtype, on q's device. H must
    be a multiple of KV (GQA)."""
    q, k, v = (torch.as_tensor(t) for t in (q, k, v))
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if q.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward; a tensor "
                           "requires grad (run the plain version, models.common.PLAIN)")
    qg, kg, vg = to_bkv(q, k, v)
    run = flash_attention_bkv_cuda if q.is_cuda else attention_plain
    return from_bkv(run(qg, kg, vg, causal=causal), q.shape[0])
