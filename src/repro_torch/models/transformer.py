"""Decoder-only LM, dense family (``repro/models/transformer.py``).

``repro`` stacks the layers on a leading axis and runs them under
``lax.scan``; here they are an ``nn.ModuleList`` run by a plain loop. The
KV cache is one preallocated tensor per k and v, ``[L, B, S_max, KV, hd]``
bf16, filled by prefill and updated in place by each decode step. A decode
step has static shapes (the position is a device tensor), so a CUDA graph
can capture it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .attention import Attention, init_attention
from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, Kernels, dense_init, frozen,
                     ones_init, position, rmsnorm)
from .mlp import SwiGLU, init_swiglu

__all__ = ["DenseLM", "init_lm", "lm_forward", "lm_prefill", "lm_decode_step",
           "lm_cache_shape"]


def _check_family(cfg) -> None:
    if cfg.family in ("moe", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: ROADMAP.md queue 1, model zoo")
    if cfg.family != "dense":
        raise ValueError(f"not a decoder-only LM family: {cfg.family}")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings are not ported yet: ROADMAP.md queue 1, model zoo")


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln1 = frozen(p["ln1"], PARAM_DTYPE)
        self.ln2 = frozen(p["ln2"], PARAM_DTYPE)
        self.attn = Attention(cfg, p["attn"])
        self.mlp = SwiGLU(p["mlp"])

    def forward(self, x, positions, kernels: Kernels = KERNELS):
        eps = self.cfg.norm_eps
        a, kv = self.attn(rmsnorm(x, self.ln1, eps, kernels), positions, kernels)
        x = x + a
        x = x + self.mlp(rmsnorm(x, self.ln2, eps, kernels))
        return x, kv

    def decode(self, x, cache_k, cache_v, pos, kernels: Kernels = KERNELS):
        eps = self.cfg.norm_eps
        x = x + self.attn.decode(rmsnorm(x, self.ln1, eps, kernels), cache_k, cache_v,
                                 pos, kernels)
        return x + self.mlp(rmsnorm(x, self.ln2, eps, kernels))


class DenseLM(nn.Module):
    """Embedding, decoder layers, final norm and untied head. ``params`` is
    the reference's parameter tree with one dict per layer: {"embed",
    "final_norm", "head", "layers": [{"ln1", "ln2", "attn", "mlp"}, ...]}."""

    def __init__(self, cfg, params: Mapping):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = frozen(params["embed"], COMPUTE_DTYPE)
        self.final_norm = frozen(params["final_norm"], PARAM_DTYPE)
        self.head = frozen(params["head"], COMPUTE_DTYPE)
        self.layers = nn.ModuleList(DecoderLayer(cfg, p) for p in params["layers"])


def init_lm(cfg, gen: torch.Generator) -> DenseLM:
    """Random parameters from ``gen``, made on its device layer by layer, so
    that at most one layer's float32 copy exists beside the bf16 weights."""
    _check_family(cfg)

    def layers():
        for _ in range(cfg.n_layers):
            yield {"attn": init_attention(cfg, gen), "ln1": ones_init(gen, (cfg.d_model,)),
                   "ln2": ones_init(gen, (cfg.d_model,)), "mlp": init_swiglu(cfg, gen)}

    return DenseLM(cfg, {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model)),
        "final_norm": ones_init(gen, (cfg.d_model,)),
        "head": dense_init(gen, (cfg.d_model, cfg.vocab)),
        "layers": layers(),
    })


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :]


def _trunk(cfg, model: DenseLM, tokens, kernels: Kernels,
           cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Embedding and decoder layers: tokens [B, S] → hidden [B, S, d]. With
    ``cache``, each layer's k and v are written into ``cache["k"][l, :, :S]``
    and ``cache["v"][l, :, :S]``."""
    s = tokens.shape[1]
    positions = _positions(s, tokens.device)
    x = model.embed[tokens]
    for i, layer in enumerate(model.layers):
        x, (k, v) = layer(x, positions, kernels)
        if cache is not None:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    return x


def _head(cfg, model: DenseLM, x, kernels: Kernels) -> torch.Tensor:
    return rmsnorm(x, model.final_norm, cfg.norm_eps, kernels) @ model.head


def lm_forward(cfg, model: DenseLM, tokens, kernels: Kernels = KERNELS) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V]."""
    return _head(cfg, model, _trunk(cfg, model, tokens, kernels), kernels)


def lm_cache_shape(cfg, batch: int, max_seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{"k", "v"}: (shape, dtype) of the KV cache."""
    _check_family(cfg)
    kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
    return {"k": kv, "v": kv}


def lm_prefill(cfg, model: DenseLM, tokens, max_seq: int, kernels: Kernels = KERNELS):
    """Forward pass that also fills a KV cache padded with zeros to
    ``max_seq``. Returns (logits of the last position [B, 1, V], cache); the
    head runs on that position only."""
    cache = {name: torch.zeros(shape, dtype=dtype, device=tokens.device)
             for name, (shape, dtype) in lm_cache_shape(cfg, tokens.shape[0], max_seq).items()}
    x = _trunk(cfg, model, tokens, kernels, cache)
    return _head(cfg, model, x[:, -1:], kernels), cache


def lm_decode_step(cfg, model: DenseLM, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at position ``pos`` (an int or a 0-d int64 tensor on the
    token's device) → (logits [B, 1, V], cache), the cache updated in
    place."""
    pos = position(pos, token.device)
    x = model.embed[token]
    for i, layer in enumerate(model.layers):
        x = layer.decode(x, cache["k"][i], cache["v"][i], pos, kernels)
    return _head(cfg, model, x, kernels), cache
