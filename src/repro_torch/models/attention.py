"""GQA attention with RoPE, optional QKV bias and qk-norm, and
cross-attention (``repro/models/attention.py``).

Prefill attention goes through the flash attention kernel: causal for
self-attention, non-causal with Sk ≠ Sq for cross-attention (vision tokens,
audio frames) and for whisper's encoder. Single-token decode attention
against a cache is plain tensor code, as in ``repro`` (einsum + softmax
outside any kernel). Decode has static shapes: self-attention attends over
the whole cache under a position mask and takes the position as a device
tensor, so a CUDA graph can replay a step; cross-attention attends over the
whole cache that prefill filled, with no mask.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from .common import (COMPUTE_DTYPE, KERNELS, NEG_INF, PARAM_DTYPE, Kernels, apply_rope,
                     dense_init, frozen, ones_init, position, rmsnorm, zeros_init)

__all__ = ["Attention", "init_attention"]


def init_attention(cfg, gen, cross: bool = False) -> dict:
    """A cross-attention layer has no QKV bias and no qk-norm, as in
    ``repro``."""
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": dense_init(gen, (d, nq)), "wk": dense_init(gen, (d, nkv)),
         "wv": dense_init(gen, (d, nkv)), "wo": dense_init(gen, (nq, d))}
    if cfg.qkv_bias and not cross:
        p["bq"] = zeros_init(gen, (nq,))
        p["bk"] = zeros_init(gen, (nkv,))
        p["bv"] = zeros_init(gen, (nkv,))
    if cfg.qk_norm and not cross:
        p["q_norm"] = ones_init(gen, (hd,))
        p["k_norm"] = ones_init(gen, (hd,))
    return p


class Attention(nn.Module):
    """One attention layer; weights ``[in, out]`` as in ``repro``, so
    ``x @ w``. The QKV biases are added in bf16 after the projections."""

    def __init__(self, cfg, p: Mapping[str, torch.Tensor], cross: bool = False):
        super().__init__()
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))
        bias = cfg.qkv_bias and not cross
        for name in ("bq", "bk", "bv"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE) if bias else None)
        norm = cfg.qk_norm and not cross
        self.q_norm = frozen(p["q_norm"], PARAM_DTYPE) if norm else None
        self.k_norm = frozen(p["k_norm"], PARAM_DTYPE) if norm else None

    def _heads(self, x, w, b, n_heads, kernels: Kernels):
        y = kernels.matmul(x, w)
        if b is not None:
            y = y + b
        # laid out before the split: a layout that splits the features is
        # gathered by ``heads`` (the plain split here)
        return kernels.heads(kernels.constrain(y), n_heads, self.cfg.hd)

    def project_q(self, x, positions: Optional[torch.Tensor], kernels: Kernels = KERNELS):
        """x [B, S, d] → q [B, S, H, hd] (bf16); qk-norm, then RoPE at
        ``positions`` unless they are None."""
        cfg = self.cfg
        q = self._heads(x, self.wq, self.bq, cfg.n_heads, kernels)
        if self.q_norm is not None:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps, kernels)
        return q if positions is None else apply_rope(q, positions, cfg.rope_theta)

    def project_kv(self, x, positions: Optional[torch.Tensor], kernels: Kernels = KERNELS):
        """x [B, S, d] → k, v [B, S, KV, hd] (bf16); k-norm and RoPE on k as
        :meth:`project_q` does on q."""
        cfg = self.cfg
        k = self._heads(x, self.wk, self.bk, cfg.n_kv_heads, kernels)
        v = self._heads(x, self.wv, self.bv, cfg.n_kv_heads, kernels)
        if self.k_norm is not None:
            k = rmsnorm(k, self.k_norm, cfg.norm_eps, kernels)
        if positions is not None:
            k = apply_rope(k, positions, cfg.rope_theta)
        return k, v

    def forward(self, x, positions, kernels: Kernels = KERNELS, *, causal: bool = True,
                kv_x: Optional[torch.Tensor] = None, rope: bool = True
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Attention over a whole sequence (prefill), positions from 0.
        Self-attention by default; ``kv_x`` [B, Sk, d] makes it
        cross-attention (keys and values from ``kv_x``). ``rope=False``
        leaves q and k unrotated. Returns (out [B, S, d], (k, v))."""
        pos = positions if rope else None
        c = kernels.constrain
        q = c(self.project_q(x, pos, kernels))
        k, v = self.project_kv(x if kv_x is None else kv_x, pos, kernels)
        if kv_x is None:  # repro lays out the self-attention k and v, not the cross ones
            k, v = c(k), c(v)
        o = kernels.attention(q, k, v, causal)
        # laid out after the heads are joined: the product's gradient comes
        # back through the layout unsplit across the heads, which a mesh axis
        # that does not divide them could not split
        return kernels.matmul(c(o.flatten(-2)), self.wo), (k, v)

    def _attend(self, q, cache_k, cache_v, visible: Optional[torch.Tensor],
                kernels: Kernels) -> torch.Tensor:
        """One query position q [B, 1, H, hd] against the cache [B, S, KV,
        hd]: scores, softmax and the weighted sum accumulate in float32, the
        weights rounded to bf16 first, as ``repro`` does; keys where
        ``visible`` is False are masked to ``NEG_INF``."""
        return kernels.decode_attention(self._attend_heads, q, cache_k, cache_v,
                                        visible) @ self.wo

    def _attend_heads(self, q, cache_k, cache_v, visible) -> torch.Tensor:
        """:meth:`_attend` before the output projection: [B, 1, H · hd] bf16."""
        cfg = self.cfg
        k = cache_k.to(torch.float32)
        v = cache_v.to(torch.float32)
        b, _, kv, hd = k.shape
        qg = q.reshape(b, 1, kv, cfg.n_heads // kv, hd).to(torch.float32)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * (hd ** -0.5)
        if visible is not None:
            s = s.masked_fill(~visible, NEG_INF)
        w = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE).to(torch.float32)
        o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
        return o.reshape(b, 1, cfg.n_heads * hd).to(COMPUTE_DTYPE)

    def decode(self, x, cache_k, cache_v, pos, kernels: Kernels = KERNELS):
        """One token x [B, 1, d] at position ``pos`` (an int or a 0-d int64
        tensor on x's device) against the cache [B, S_max, KV, hd]. Writes
        this token's k and v into the cache in place at ``pos`` (``repro``
        makes a new cache by a one-hot update, which gives the same values)
        and attends over the whole cache with the positions after ``pos``
        masked, as ``repro`` does: no shape and no host read depends on
        ``pos``."""
        pos = position(pos, x.device)
        q = self.project_q(x, pos.view(1, 1), kernels)
        k_new, v_new = self.project_kv(x, pos.view(1, 1), kernels)
        kernels.write_at(cache_k, pos, k_new)
        kernels.write_at(cache_v, pos, v_new)
        visible = torch.arange(cache_k.shape[1], device=x.device) <= pos
        return self._attend(q, cache_k, cache_v, visible, kernels)

    def decode_cross(self, x, cache_k, cache_v, kernels: Kernels = KERNELS):
        """One token x [B, 1, d] against a cross-attention cache [B, Sk, KV,
        hd] that prefill filled: q only is projected (``repro`` also projects
        k and v of a stand-in and discards them), no RoPE, no mask, no
        update."""
        return self._attend(self.project_q(x, None, kernels), cache_k, cache_v, None, kernels)
