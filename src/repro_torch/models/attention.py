"""GQA attention with RoPE and optional qk-norm (``repro/models/attention.py``).

Prefill attention goes through the flash attention kernel; single-token
decode attention against the KV cache is plain tensor code, as in
``repro`` (einsum + masked softmax outside any kernel).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch import nn

from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, Kernels, apply_rope,
                     dense_init, frozen, ones_init, rmsnorm)

__all__ = ["Attention", "init_attention"]


def init_attention(cfg, gen) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": dense_init(gen, (d, nq)), "wk": dense_init(gen, (d, nkv)),
         "wv": dense_init(gen, (d, nkv)), "wo": dense_init(gen, (nq, d))}
    if cfg.qk_norm:
        p["q_norm"] = ones_init(gen, (hd,))
        p["k_norm"] = ones_init(gen, (hd,))
    return p


class Attention(nn.Module):
    """Self-attention of one decoder layer; weights ``[in, out]`` as in
    ``repro``, so ``x @ w``."""

    def __init__(self, cfg, p: Mapping[str, torch.Tensor]):
        super().__init__()
        if cfg.qkv_bias:
            raise NotImplementedError(
                "QKV bias (qwen1.5) is not ported yet: ROADMAP.md queue 1, model zoo")
        self.cfg = cfg
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))
        self.q_norm = frozen(p["q_norm"], PARAM_DTYPE) if cfg.qk_norm else None
        self.k_norm = frozen(p["k_norm"], PARAM_DTYPE) if cfg.qk_norm else None

    def project_qkv(self, x, positions, kernels: Kernels = KERNELS):
        """x [B, S, d] → q [B, S, H, hd], k / v [B, S, KV, hd] (bf16), with
        qk-norm and RoPE applied to q and k."""
        cfg = self.cfg
        q = (x @ self.wq).unflatten(-1, (cfg.n_heads, cfg.hd))
        k = (x @ self.wk).unflatten(-1, (cfg.n_kv_heads, cfg.hd))
        v = (x @ self.wv).unflatten(-1, (cfg.n_kv_heads, cfg.hd))
        if self.q_norm is not None:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps, kernels)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps, kernels)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def forward(self, x, positions, kernels: Kernels = KERNELS
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Causal attention over the whole sequence (prefill), positions
        from 0. Returns (out [B, S, d], (k, v))."""
        q, k, v = self.project_qkv(x, positions, kernels)
        o = kernels.attention(q, k, v, True)
        return o.flatten(-2) @ self.wo, (k, v)

    def decode(self, x, cache_k, cache_v, pos: int, kernels: Kernels = KERNELS):
        """One token x [B, 1, d] at position ``pos`` against the cache
        [B, S_max, KV, hd]. Writes this token's k and v into the cache in
        place (``repro`` makes a new cache by a one-hot update, which gives
        the same values) and attends over positions 0..pos. Scores, softmax
        and the weighted sum accumulate in float32, the weights rounded to
        bf16 first, as ``repro`` does."""
        cfg = self.cfg
        positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new, v_new = self.project_qkv(x, positions, kernels)
        cache_k[:, pos] = k_new[:, 0]
        cache_v[:, pos] = v_new[:, 0]
        k = cache_k[:, :pos + 1].to(torch.float32)
        v = cache_v[:, :pos + 1].to(torch.float32)
        b, _, kv, hd = k.shape
        qg = q.reshape(b, 1, kv, cfg.n_heads // kv, hd).to(torch.float32)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) * (hd ** -0.5)
        w = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE).to(torch.float32)
        o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
        o = o.reshape(b, 1, cfg.n_heads * hd).to(COMPUTE_DTYPE)
        return o @ self.wo
