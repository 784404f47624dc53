"""Model-layout flash attention.

The counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``:
it regroups the model's ``[B, S, H, hd]`` / ``[B, S, KV, hd]`` layout into
the kernel's ``[B·KV, S, G, hd]`` / ``[B·KV, S, hd]`` and back, with
positions counted from 0 (what prefill uses). Dispatch is on q's device
alone: on a card the kernel runs (or the call raises); on the CPU the plain
version runs. The kernel has no backward: on a card, with grad mode on, a
tensor that requires grad makes the call raise (its output would carry no
gradient); the loss runs the plain version instead.

:func:`work` is one call's work (``kernels/counted.py``), and
:func:`flash_attention_counted` the stand-in that adds it to a count on
``meta``.
"""

from __future__ import annotations

import torch

from ..counted import Work, add_work
from .kernel import flash_attention_bkv_cuda
from .ref import attention_plain

__all__ = ["flash_attention", "to_bkv", "from_bkv", "work", "flash_attention_counted"]


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


def _check_heads(q, k) -> None:
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")


def flash_attention(q, k, v, *, causal: bool = True, q_start: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd] on q's device (tensors, or
    numpy for the CPU) → [B, Sq, H, hd] in q's dtype, on q's device. H must
    be a multiple of KV (GQA). Causal query row i sees the keys at positions
    ≤ ``q_start`` + i: q is then the rows of a longer sequence from
    ``q_start`` on, k and v that sequence whole."""
    q, k, v = (torch.as_tensor(t) for t in (q, k, v))
    _check_heads(q, k)
    if q.is_cuda and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward; a tensor "
                           "requires grad (run the plain version, models.common.PLAIN)")
    qg, kg, vg = to_bkv(q, k, v)
    run = flash_attention_bkv_cuda if q.is_cuda else attention_plain
    return from_bkv(run(qg, kg, vg, causal=causal, q_start=q_start), q.shape[0])


def _visible_pairs(sq: int, sk: int, causal: bool, q_start: int = 0) -> int:
    """(query, key) pairs the mask leaves, the keys' positions counted from
    0 and the queries' from ``q_start``: Σ_i min(q_start + i + 1, sk) when
    causal, else sq·sk."""
    if not causal:
        return sq * sk

    def tri(n):  # Σ_{i < n} min(i + 1, sk)
        return n * (n + 1) // 2 if n <= sk else sk * (sk + 1) // 2 + (n - sk) * sk

    return tri(q_start + sq) - tri(q_start)


def work(b: int, sq: int, sk: int, h: int, kv: int, hd: int, causal: bool,
         elt: int, q_start: int = 0) -> Work:
    """One call: the plain version's two products over every (query, key)
    pair, 2·2·B·H·Sq·Sk·hd (the mask applies after q·kᵀ); q and k, v read
    once and o written once; the operations the visible pairs need."""
    return Work(flops=4 * b * h * sq * sk * hd,
                bytes=(2 * b * sq * h + 2 * b * sk * kv) * hd * elt,
                ops=4 * b * h * _visible_pairs(sq, sk, causal, q_start) * hd)


def flash_attention_counted(q, k, v, *, causal: bool = True, q_start: int = 0) -> torch.Tensor:
    """The kernel's stand-in on ``meta``: adds :func:`work` to the open
    count and returns an empty [B, Sq, H, hd] in q's dtype, through the
    wrapper's own layout copies."""
    _check_heads(q, k)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    add_work("flash_attention", (q, k, v), work(b, sq, sk, h, kv, hd, causal,
                                                q.element_size(), q_start))
    qg, _, _ = to_bkv(q, k, v)
    return from_bkv(torch.empty_like(qg), b)
