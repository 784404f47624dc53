"""Decoder-only LM: the dense, moe and vlm families
(``repro/models/transformer.py``).

``repro`` stacks the layers on a leading axis and runs them under
``lax.scan``; here they are an ``nn.ModuleList`` run by a plain loop. A
layer is pre-norm self-attention then a SwiGLU MLP (dense, vlm) or the
routed experts (moe). vlm (llama-3.2-vision) runs its layers in groups of
``cross_attn_every``: that many minus one self layers, then one
cross-attention layer over the vision tokens whose residual is scaled by
``tanh(gate)``. ``tie_embeddings`` (qwen1.5) makes the head the embedding's
transpose: one bf16 tensor, read both ways.

The KV cache is one preallocated tensor per leaf, filled by prefill: ``k``
and ``v`` ``[L_self, B, S_max, KV, hd]`` bf16 (vlm's self layers in order,
group by group, as ``repro`` merges its group dims), updated in place by
each decode step; vlm adds ``cross_k`` / ``cross_v`` ``[n_groups, B,
n_vision, KV, hd]``, which decode only reads. A decode step has static
shapes (the position is a device tensor), so a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .attention import Attention, init_attention
from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, PLAIN, Kernels, dense_init,
                     frozen, ones_init, position, rmsnorm, run_layer)
from .mlp import SwiGLU, init_swiglu
from .moe import MoE, init_moe
from .sharding import CROSS_CACHE, KV_CACHE

__all__ = ["DecoderLM", "init_lm", "lm_forward", "lm_loss", "lm_prefill", "lm_decode_step",
           "lm_cache_shape", "vlm_layout"]


def vlm_layout(cfg) -> Tuple[int, int]:
    """(number of groups, self layers per group) of a vlm config; (0,
    n_layers) otherwise."""
    if cfg.family != "vlm":
        return 0, cfg.n_layers
    per = cfg.cross_attn_every
    if per < 2 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                         f"cross_attn_every {per} (at least one self layer each)")
    return cfg.n_layers // per, per - 1


def _n_self(cfg) -> int:
    n_groups, per_group = vlm_layout(cfg)
    return n_groups * per_group if n_groups else cfg.n_layers


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"not a decoder-only LM family: {cfg.family}")
    vlm_layout(cfg)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln1 = frozen(p["ln1"], PARAM_DTYPE)
        self.ln2 = frozen(p["ln2"], PARAM_DTYPE)
        self.attn = Attention(cfg, p["attn"])
        self.mlp = MoE(cfg, p["moe"]) if cfg.family == "moe" else SwiGLU(p["mlp"])

    def forward(self, x, positions, kernels: Kernels = KERNELS):
        x, kv, _ = self.block(x, positions, kernels)
        return x, kv

    def block(self, x, positions, kernels: Kernels = KERNELS, with_aux: bool = False):
        """(x after the layer, (k, v), the MoE load-balance loss when
        ``with_aux`` on a moe layer, else None)."""
        eps, c = self.cfg.norm_eps, kernels.constrain
        a, kv = self.attn(rmsnorm(x, self.ln1, eps, kernels), positions, kernels)
        x = c(x + a)
        h = rmsnorm(x, self.ln2, eps, kernels)
        if with_aux and isinstance(self.mlp, MoE):
            m, aux = self.mlp(h, with_aux=True, kernels=kernels)
            return c(x + m), kv, aux
        return c(x + self.mlp(h, kernels=kernels)), kv, None

    def decode(self, x, cache_k, cache_v, pos, kernels: Kernels = KERNELS):
        eps, c = self.cfg.norm_eps, kernels.constrain
        x = c(x + self.attn.decode(rmsnorm(x, self.ln1, eps, kernels), cache_k, cache_v,
                                   pos, kernels))
        return c(x + self.mlp(rmsnorm(x, self.ln2, eps, kernels), kernels=kernels))


class CrossLayer(nn.Module):
    """llama-3.2-vision's gated cross-attention layer: x + tanh(gate) ·
    attn(rmsnorm(x), vision), no RoPE, no mask."""

    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln = frozen(p["ln"], PARAM_DTYPE)
        self.attn = Attention(cfg, p["attn"], cross=True)
        self.gate = frozen(p["gate"], PARAM_DTYPE)

    def _gate(self) -> torch.Tensor:
        return torch.tanh(self.gate).to(COMPUTE_DTYPE)

    def forward(self, x, vision, kernels: Kernels = KERNELS):
        h = rmsnorm(x, self.ln, self.cfg.norm_eps, kernels)
        a, kv = self.attn(h, None, kernels, causal=False, kv_x=vision, rope=False)
        return kernels.constrain(x + self._gate() * a), kv

    def decode(self, x, cache_k, cache_v, kernels: Kernels = KERNELS):
        h = rmsnorm(x, self.ln, self.cfg.norm_eps, kernels)
        return kernels.constrain(
            x + self._gate() * self.attn.decode_cross(h, cache_k, cache_v, kernels))


class DecoderLM(nn.Module):
    """Embedding, decoder layers, final norm and head. ``params`` is the
    reference's parameter tree with one dict per layer: {"embed",
    "final_norm", "head" (untied only), "layers": [{"ln1", "ln2", "attn",
    "mlp" | "moe"}, ...]}, and for vlm "cross": [{"ln", "attn", "gate"},
    ...], one per group; "layers" then holds the self layers of all groups
    in order."""

    def __init__(self, cfg, params: Mapping):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = frozen(params["embed"], COMPUTE_DTYPE)
        self.final_norm = frozen(params["final_norm"], PARAM_DTYPE)
        self.head = None if cfg.tie_embeddings else frozen(params["head"], COMPUTE_DTYPE)
        self.layers = nn.ModuleList(DecoderLayer(cfg, p) for p in params["layers"])
        self.cross = nn.ModuleList(CrossLayer(cfg, p) for p in params.get("cross", ()))
        n_groups, _ = vlm_layout(cfg)
        if len(self.layers) != _n_self(cfg) or len(self.cross) != n_groups:
            raise ValueError(f"{cfg.name}: {len(self.layers)} self and {len(self.cross)} "
                             f"cross layers, want {_n_self(cfg)} and {n_groups}")

    def head_weight(self) -> torch.Tensor:
        """[d, V]: the head, or the embedding's transpose when tied."""
        return self.embed.t() if self.head is None else self.head


def _init_layer(cfg, gen) -> dict:
    p = {"attn": init_attention(cfg, gen), "ln1": ones_init(gen, (cfg.d_model,)),
         "ln2": ones_init(gen, (cfg.d_model,))}
    if cfg.family == "moe":
        p["moe"] = init_moe(cfg, gen)
    else:
        p["mlp"] = init_swiglu(cfg, gen)
    return p


def init_lm(cfg, gen: torch.Generator) -> DecoderLM:
    """Random parameters from ``gen``, made on its device layer by layer, so
    that at most one layer's float32 copy exists beside the bf16 weights.
    The cross layers' gates start at zero, as ``repro``'s do."""
    _check_family(cfg)
    n_groups, _ = vlm_layout(cfg)
    params = {"embed": dense_init(gen, (cfg.vocab, cfg.d_model)),
              "final_norm": ones_init(gen, (cfg.d_model,))}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab))
    params["layers"] = (_init_layer(cfg, gen) for _ in range(_n_self(cfg)))
    params["cross"] = ({"attn": init_attention(cfg, gen, cross=True),
                        "ln": ones_init(gen, (cfg.d_model,)),
                        "gate": dense_init(gen, (1,), scale=0.0)} for _ in range(n_groups))
    return DecoderLM(cfg, params)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :]


def _cross_after(cfg, i: int) -> Optional[int]:
    """The group whose cross layer runs after self layer ``i``, if any."""
    n_groups, per_group = vlm_layout(cfg)
    if n_groups and (i + 1) % per_group == 0:
        return (i + 1) // per_group - 1
    return None


def _trunk(cfg, model: DecoderLM, tokens, kernels: Kernels,
           cache: Optional[Dict[str, torch.Tensor]] = None, vision=None) -> torch.Tensor:
    """Embedding and decoder layers: tokens [B, S] → hidden [B, S, d]. With
    ``cache``, self layer i's k and v are written into ``cache["k"][i, :,
    :S]`` and ``cache["v"][i, :, :S]``, and group g's cross k and v into
    ``cache["cross_k"][g]`` and ``cache["cross_v"][g]``."""
    if cfg.family == "vlm" and vision is None:
        raise ValueError(f"{cfg.name}: the vlm family needs the vision stand-in")
    s = tokens.shape[1]
    positions = _positions(s, tokens.device)
    x = kernels.constrain(kernels.embed(model.embed, tokens))
    for i, layer in enumerate(model.layers):
        x, (k, v) = layer(x, positions, kernels)
        if cache is not None:
            kernels.write_prefix(cache["k"], i, k)
            kernels.write_prefix(cache["v"], i, v)
        g = _cross_after(cfg, i)
        if g is not None:
            x, (k, v) = model.cross[g](x, vision, kernels)
            if cache is not None:
                kernels.write_prefix(cache["cross_k"], g, k)
                kernels.write_prefix(cache["cross_v"], g, v)
    return x


def _head(cfg, model: DecoderLM, x, kernels: Kernels) -> torch.Tensor:
    return kernels.matmul(rmsnorm(x, model.final_norm, cfg.norm_eps, kernels),
                          model.head_weight())


def lm_forward(cfg, model: DecoderLM, tokens, kernels: Kernels = KERNELS,
               vision=None) -> torch.Tensor:
    """tokens [B, S] (and vlm's vision [B, n_vision, d]) → logits [B, S, V]."""
    return _head(cfg, model, _trunk(cfg, model, tokens, kernels, vision=vision), kernels)


def _loss_layer(layer: DecoderLayer, x, positions, kernels: Kernels):
    x, _, aux = layer.block(x, positions, kernels, with_aux=True)
    return x, aux


def _loss_cross(layer: CrossLayer, x, vision, kernels: Kernels):
    return layer(x, vision, kernels)[0]


def lm_loss(cfg, model: DecoderLM, tokens, labels, vision=None, remat: bool = True,
            kernels: Kernels = PLAIN):
    """(loss, ce), ``repro``'s ``lm_loss``: the mean cross-entropy of the
    logits against ``labels`` [B, S], plus 0.01 · the layers' summed
    load-balance losses for moe. With ``remat`` each self layer and each
    vlm cross layer keeps only its input for the backward, as ``repro``'s
    checkpointed scan bodies do."""
    if cfg.family == "vlm" and vision is None:
        raise ValueError(f"{cfg.name}: the vlm family needs the vision stand-in")
    positions = _positions(tokens.shape[1], tokens.device)
    x = kernels.constrain(kernels.embed(model.embed, tokens))
    aux = None
    for i, layer in enumerate(model.layers):
        x, a = run_layer(_loss_layer, layer, x, positions, kernels, remat=remat)
        if a is not None:
            aux = a if aux is None else aux + a
        g = _cross_after(cfg, i)
        if g is not None:
            x = run_layer(_loss_cross, model.cross[g], x, vision, kernels, remat=remat)
    ce = kernels.cross_entropy(_head(cfg, model, x, kernels), labels)
    return (ce + 0.01 * aux if aux is not None else ce), ce


def lm_cache_shape(cfg, batch: int, max_seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{"k", "v"} (vlm: and {"cross_k", "cross_v"}): (shape, dtype) of the
    cache."""
    _check_family(cfg)
    kv = ((_n_self(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
    out = {"k": kv, "v": kv}
    n_groups, _ = vlm_layout(cfg)
    if n_groups:
        cross = ((n_groups, batch, cfg.n_vision_tokens, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
        out.update(cross_k=cross, cross_v=cross)
    return out


def lm_cache_logical(cfg):
    """The logical axes of each :func:`lm_cache_shape` leaf: the self caches
    sharded along the sequence, the cross caches along the batch only."""
    out = {"k": KV_CACHE, "v": KV_CACHE}
    if vlm_layout(cfg)[0]:
        out.update(cross_k=CROSS_CACHE, cross_v=CROSS_CACHE)
    return out


def lm_prefill(cfg, model: DecoderLM, tokens, max_seq: int, kernels: Kernels = KERNELS,
               vision=None):
    """Forward pass that also fills a KV cache padded with zeros to
    ``max_seq``. Returns (logits of the last position [B, 1, V], cache); the
    head runs on that position only."""
    cache = kernels.new_cache(lm_cache_shape(cfg, tokens.shape[0], max_seq), tokens,
                              lm_cache_logical(cfg))
    x = _trunk(cfg, model, tokens, kernels, cache, vision)
    return _head(cfg, model, x[:, -1:], kernels), cache


def lm_decode_step(cfg, model: DecoderLM, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at position ``pos`` (an int or a 0-d int64 tensor on the
    token's device) → (logits [B, 1, V], cache), the self-attention cache
    updated in place."""
    pos = position(pos, token.device)
    x = kernels.constrain(kernels.embed(model.embed, token))
    for i, layer in enumerate(model.layers):
        x = layer.decode(x, cache["k"][i], cache["v"][i], pos, kernels)
        g = _cross_after(cfg, i)
        if g is not None:
            x = model.cross[g].decode(x, cache["cross_k"][g], cache["cross_v"][g], kernels)
    return _head(cfg, model, x, kernels), cache
