"""Recurrent and hybrid LM assemblies (``repro/models/recurrent.py``):
xLSTM (the ssm family) and Zamba2 (the hybrid family).

xlstm-1.3b: blocks in groups of ``slstm_every``, (slstm_every − 1) mLSTM
blocks followed by one sLSTM block, each block pre-normed and residual. 48
layers = 6 groups of 7 mLSTM + 1 sLSTM. ``repro`` scans over the stacked
groups; here they are nested ``nn.ModuleList``s run by plain loops. The
"cache" is the recurrent state, O(1) in sequence length, stacked as the
reference stacks it: mLSTM states [G, n_m, B, ...], sLSTM states [G, B, ...],
all float32, updated in place by each decode step.

zamba2-7b: ``n_layers // attn_every`` groups of ``attn_every`` pre-normed
residual Mamba2 blocks, each group followed by one application of the
SHARED attention + MLP block (one set of weights, applied once per group,
its input concat([hidden, token embedding]) of width 2d), then the
remaining ``n_layers % attn_every`` Mamba2 blocks (the tail). 81 = 13·6 + 3
at full width; the smoke config has no tail. The cache holds the Mamba2
states stacked as ``repro`` stacks them ("groups" [G, attn_every, B, ...],
"tail" [rem, B, ...], or None without a tail, as in ``repro``) and one KV
cache per application of the shared block ("attn_k", "attn_v" [G, B,
max_seq, KV, hd] bfloat16). The conv leaves are float32, as ``repro``'s
``cache_shape`` declares them (its prefill returns them in bfloat16; the
values are bfloat16 either way), so one static decode graph takes every
cache.

Under a mesh (``kernels.constrain`` lays out the residual stream at each
block's output, ``repro``'s sites) the Mamba2 cells split their heads over
a mesh axis the batch leaves free (``kernels.ssd``), the sLSTM recurrence
runs on each device's batch block (``kernels.local``), and the shared block
lays out its q, k, v along the batch and ``kv_seq``, as ``repro`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from .attention import Attention
from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, PLAIN, Kernels, dense_init,
                     frozen, ones_init, position, rmsnorm, run_layer)
from .mlp import SwiGLU, init_swiglu
from .sharding import KV_CACHE
from .ssm import CONV_K, Mamba2, init_mamba, mamba_dims
from .xlstm import (MLSTMCell, SLSTMCell, init_mlstm, init_slstm, mlstm_dims, slstm_dims)

__all__ = ["XLSTMLM", "init_xlstm_lm", "xlstm_groups", "xlstm_loss", "xlstm_prefill",
           "xlstm_decode_step", "xlstm_cache_shape", "ZambaLM", "init_zamba_lm", "zamba_groups",
           "zamba_loss", "zamba_prefill", "zamba_decode_step", "zamba_cache_shape"]


def xlstm_groups(cfg) -> Tuple[int, int]:
    """(number of groups, mLSTM blocks per group)."""
    per = cfg.slstm_every
    if cfg.family != "ssm" or per < 1 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: not an xLSTM layout (family {cfg.family}, "
                         f"{cfg.n_layers} layers, slstm_every {per})")
    return cfg.n_layers // per, per - 1


class MLSTMBlock(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln = frozen(p["ln"], PARAM_DTYPE)
        self.cell = MLSTMCell(cfg, p["cell"])

    def forward(self, x, kernels: Kernels = KERNELS):
        y, state = self.cell(kernels.rmsnorm(x, self.ln, self.cfg.norm_eps), kernels)
        return kernels.constrain(x + y), state

    def decode(self, x, state, kernels: Kernels = KERNELS):
        y, state = self.cell.decode(kernels.rmsnorm(x, self.ln, self.cfg.norm_eps), state,
                                    kernels)
        return kernels.constrain(x + y), state


class XLSTMGroup(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.m = nn.ModuleList(MLSTMBlock(cfg, bp) for bp in p["m"])
        self.s = SLSTMCell(cfg, p["s"])
        self.s_ln = frozen(p["s_ln"], PARAM_DTYPE)

    def slstm(self, x, state, kernels: Kernels = KERNELS):
        y, state = self.s(kernels.rmsnorm(x, self.s_ln, self.cfg.norm_eps), state, kernels)
        return kernels.constrain(x + y), state


class XLSTMLM(nn.Module):
    """Embedding, the groups of blocks, final norm and untied head.
    ``params``: {"embed", "final_norm", "head", "groups": [{"m": [{"cell",
    "ln"}, ...], "s", "s_ln"}, ...]}. The model computes in its embedding's
    type."""

    def __init__(self, cfg, params: Mapping):
        super().__init__()
        xlstm_groups(cfg)
        self.cfg = cfg
        self.embed = frozen(params["embed"], COMPUTE_DTYPE)
        self.final_norm = frozen(params["final_norm"], PARAM_DTYPE)
        self.head = frozen(params["head"], COMPUTE_DTYPE)
        self.groups = nn.ModuleList(XLSTMGroup(cfg, g) for g in params["groups"])


def init_xlstm_lm(cfg, gen: torch.Generator) -> XLSTMLM:
    """Random parameters from ``gen``, made on its device group by group."""
    n_groups, n_m = xlstm_groups(cfg)
    d = cfg.d_model

    def groups():
        for _ in range(n_groups):
            yield {"m": [{"cell": init_mlstm(cfg, gen), "ln": ones_init(gen, (d,))}
                         for _ in range(n_m)],
                   "s": init_slstm(cfg, gen), "s_ln": ones_init(gen, (d,))}

    return XLSTMLM(cfg, {"embed": dense_init(gen, (cfg.vocab, d)),
                         "final_norm": ones_init(gen, (d,)),
                         "head": dense_init(gen, (d, cfg.vocab)), "groups": groups()})


def xlstm_cache_shape(cfg, batch: int, max_seq: int
                      ) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], torch.dtype]]]:
    """{"m": {"C", "n", "m"}, "s": {"c", "n", "h", "m"}}: (shape, dtype) of
    the recurrent state; ``max_seq`` does not enter."""
    del max_seq
    n_groups, n_m = xlstm_groups(cfg)
    _, H, hd = mlstm_dims(cfg)
    sH, shd = slstm_dims(cfg)
    f32 = torch.float32
    lead = (n_groups, n_m, batch, H)
    return {"m": {"C": (lead + (hd, hd), f32), "n": (lead + (hd,), f32), "m": (lead, f32)},
            "s": {name: ((n_groups, batch, sH, shd), f32) for name in ("c", "n", "h", "m")}}


def _head(cfg, model: XLSTMLM, x, kernels: Kernels) -> torch.Tensor:
    return kernels.rmsnorm(x, model.final_norm, cfg.norm_eps) @ model.head


def _hidden(block, *args):
    """A residual block's output without its recurrent state."""
    return block(*args)[0]


def xlstm_loss(cfg, model: XLSTMLM, tokens, labels, remat: bool = True,
               kernels: Kernels = PLAIN):
    """(ce, ce), ``repro``'s ``xlstm_loss``: every block from the zero
    state; with ``remat`` each mLSTM block keeps only its input for the
    backward (``repro`` checkpoints its inner scan's body), the sLSTM blocks
    keep everything, as in ``repro``."""
    x = kernels.constrain(kernels.embed(model.embed, tokens))
    for group in model.groups:
        for block in group.m:
            x = run_layer(_hidden, block, x, kernels, remat=remat)
        x, _ = group.slstm(x, None, kernels)
    ce = kernels.cross_entropy(_head(cfg, model, x, kernels), labels)
    return ce, ce


def xlstm_prefill(cfg, model: XLSTMLM, tokens, max_seq: int, kernels: Kernels = KERNELS):
    """tokens [B, S] → (logits of the last position [B, 1, V], cache): every
    block from the zero state, its final state written into the cache."""
    cache = kernels.new_cache(xlstm_cache_shape(cfg, tokens.shape[0], max_seq), tokens,
                              xlstm_cache_logical(), make=torch.empty)
    x = kernels.constrain(kernels.embed(model.embed, tokens))
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group.m):
            x, state = block(x, kernels)
            _store(cache["m"], state, g, j)
        x, state = group.slstm(x, None, kernels)
        _store(cache["s"], state, g)
    return _head(cfg, model, x[:, -1:], kernels), cache


def xlstm_decode_step(cfg, model: XLSTMLM, cache, token, pos,
                      kernels: Kernels = KERNELS):
    """token [B, 1] → (logits [B, 1, V], cache updated in place). ``pos`` (an
    int or a 0-d tensor) is not used: the recurrent state carries the
    position, and every shape is static."""
    del pos
    x = kernels.constrain(kernels.embed(model.embed, token))
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group.m):
            x, state = block.decode(x, {n: t[g, j] for n, t in cache["m"].items()}, kernels)
            _store(cache["m"], state, g, j)
        x, state = group.slstm(x, {n: t[g] for n, t in cache["s"].items()}, kernels)
        _store(cache["s"], state, g)
    return _head(cfg, model, x, kernels), cache


# -- Zamba2 ----------------------------------------------------------------------


def zamba_groups(cfg) -> Tuple[int, int]:
    """(number of groups, tail blocks): ``attn_every`` Mamba2 blocks a group."""
    if cfg.family != "hybrid" or cfg.attn_every < 1:
        raise ValueError(f"{cfg.name}: not a Zamba2 layout (family {cfg.family}, "
                         f"attn_every {cfg.attn_every})")
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


class MambaBlock(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln = frozen(p["ln"], PARAM_DTYPE)
        self.cell = Mamba2(cfg, p["cell"])

    def forward(self, x, kernels: Kernels = KERNELS):
        y, state = kernels.ssd(self.cell, rmsnorm(x, self.ln, self.cfg.norm_eps, kernels))
        return kernels.constrain(x + y), state

    def decode(self, x, state, kernels: Kernels = KERNELS):
        y, state = kernels.ssd(self.cell, rmsnorm(x, self.ln, self.cfg.norm_eps, kernels),
                               state, decode=True)
        return kernels.constrain(x + y), state


class SharedBlock(nn.Module):
    """Zamba's shared attention + SwiGLU block. Its input is cat = concat([x,
    e0]) of width 2d (e0: the token embedding of this forward): RMSNorm
    over 2d, attention with q/k/v projected from 2d, the residual onto x;
    then RMSNorm and SwiGLU over d."""

    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.ln = frozen(p["ln"], PARAM_DTYPE)
        self.mlp_ln = frozen(p["mlp_ln"], PARAM_DTYPE)
        self.attn = Attention(cfg, p)
        self.mlp = SwiGLU(p["mlp"])

    def _cat(self, x, e0, kernels):
        return rmsnorm(torch.cat([x, e0], dim=-1), self.ln, self.cfg.norm_eps, kernels)

    def _mlp(self, x, kernels):
        c = kernels.constrain
        return c(x + self.mlp(rmsnorm(x, self.mlp_ln, self.cfg.norm_eps, kernels), kernels))

    def forward(self, x, e0, positions, kernels: Kernels = KERNELS):
        # repro lays out this block's q, k, v along the batch and kv_seq, the
        # mesh axes the batch left free (the identity off a mesh)
        def qkv_layout(a):
            if a.dim() == 4:
                return kernels.layout(a, "batch", "kv_seq", None, None)
            return a

        qkv = dataclasses.replace(kernels, constrain=qkv_layout)
        a, kv = self.attn(self._cat(x, e0, kernels), positions, qkv)
        return self._mlp(kernels.constrain(x + a), kernels), kv

    def decode(self, x, e0, cache_k, cache_v, pos, kernels: Kernels = KERNELS):
        a = self.attn.decode(self._cat(x, e0, kernels), cache_k, cache_v, pos, kernels)
        return self._mlp(kernels.constrain(x + a), kernels)


class ZambaLM(nn.Module):
    """Embedding, the groups of Mamba2 blocks with the shared block after
    each, the tail blocks, final norm and untied head. ``params``:
    {"embed", "final_norm", "head", "groups": [[{"cell", "ln"}, ...], ...],
    "tail": [{"cell", "ln"}, ...], "shared": {"wq", "wk", "wv", "wo", "ln",
    "mlp_ln", "mlp"}}."""

    def __init__(self, cfg, params: Mapping):
        super().__init__()
        n_groups, rem = zamba_groups(cfg)
        self.cfg = cfg
        self.embed = frozen(params["embed"], COMPUTE_DTYPE)
        self.final_norm = frozen(params["final_norm"], PARAM_DTYPE)
        self.head = frozen(params["head"], COMPUTE_DTYPE)
        self.groups = nn.ModuleList(nn.ModuleList(MambaBlock(cfg, p) for p in g)
                                    for g in params["groups"])
        self.tail = nn.ModuleList(MambaBlock(cfg, p) for p in params.get("tail", ()))
        self.shared = SharedBlock(cfg, params["shared"])
        if (len(self.groups), len(self.tail)) != (n_groups, rem) or any(
                len(g) != cfg.attn_every for g in self.groups):
            raise ValueError(f"{cfg.name}: {[len(g) for g in self.groups]} group blocks and "
                             f"{len(self.tail)} tail blocks, want {n_groups} × "
                             f"{cfg.attn_every} and {rem}")


def init_zamba_lm(cfg, gen: torch.Generator) -> ZambaLM:
    """Random parameters from ``gen``, made on its device block by block."""
    n_groups, rem = zamba_groups(cfg)
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def block():
        return {"cell": init_mamba(cfg, gen), "ln": ones_init(gen, (d,))}

    groups = ((block() for _ in range(cfg.attn_every)) for _ in range(n_groups))
    shared = {"wq": dense_init(gen, (2 * d, nq)), "wk": dense_init(gen, (2 * d, nkv)),
              "wv": dense_init(gen, (2 * d, nkv)), "wo": dense_init(gen, (nq, d)),
              "ln": ones_init(gen, (2 * d,)), "mlp_ln": ones_init(gen, (d,)),
              "mlp": init_swiglu(cfg, gen)}
    return ZambaLM(cfg, {"embed": dense_init(gen, (cfg.vocab, d)),
                         "final_norm": ones_init(gen, (d,)),
                         "head": dense_init(gen, (d, cfg.vocab)), "groups": groups,
                         "tail": (block() for _ in range(rem)), "shared": shared})


def zamba_cache_shape(cfg, batch: int, max_seq: int):
    """{"groups": {"ssm", "conv"}, "tail": {"ssm", "conv"} or None, "attn_k",
    "attn_v"}: (shape, dtype) of each leaf; the Mamba2 states float32."""
    n_groups, rem = zamba_groups(cfg)
    d_in, H, P, N = mamba_dims(cfg)
    f32 = torch.float32

    def states(*lead):
        return {"ssm": (lead + (batch, H, P, N), f32),
                "conv": (lead + (batch, CONV_K - 1, d_in + 2 * N), f32)}

    kv = ((n_groups, batch, max_seq, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
    return {"groups": states(n_groups, cfg.attn_every), "tail": states(rem) if rem else None,
            "attn_k": kv, "attn_v": kv}


def _zamba_head(cfg, model: ZambaLM, x, kernels: Kernels) -> torch.Tensor:
    return rmsnorm(x, model.final_norm, cfg.norm_eps, kernels) @ model.head


def _store(leaves, state, *index) -> None:
    for name, t in state.items():
        leaves[name][index].copy_(t)


def xlstm_cache_logical():
    """The logical axes of each :func:`xlstm_cache_shape` leaf."""
    return {"m": {"C": ("layers", "none", "batch", "none", "feat", "none"),
                  "n": ("layers", "none", "batch", "none", "feat"),
                  "m": ("layers", "none", "batch", "none")},
            "s": {k: ("layers", "batch", "none", "none") for k in ("c", "n", "h", "m")}}


def zamba_cache_logical(cfg):
    """The logical axes of each :func:`zamba_cache_shape` leaf."""
    return {"groups": {"ssm": ("layers", "none", "batch", "feat", "none", "none"),
                       "conv": ("layers", "none", "batch", "none", "feat")},
            "tail": ({"ssm": ("layers", "batch", "feat", "none", "none"),
                      "conv": ("layers", "batch", "none", "feat")}
                     if zamba_groups(cfg)[1] else None),
            "attn_k": KV_CACHE, "attn_v": KV_CACHE}


def zamba_prefill(cfg, model: ZambaLM, tokens, max_seq: int, kernels: Kernels = KERNELS):
    """tokens [B, S] → (logits of the last position [B, 1, V], cache): every
    Mamba2 block from the zero state, its final state written into the
    cache; each shared-block application's k and v into its KV cache, padded
    with zeros to ``max_seq``. S must be a multiple of 128, or at most 128."""
    b, s = tokens.shape
    shapes, logical = zamba_cache_shape(cfg, b, max_seq), zamba_cache_logical(cfg)
    cache = {part: kernels.new_cache(leaves, tokens, logical[part],
                                     make=torch.zeros if part.startswith("attn") else torch.empty)
             for part, leaves in shapes.items()}
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = e0 = kernels.constrain(kernels.embed(model.embed, tokens))
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group):
            x, state = block(x, kernels)
            _store(cache["groups"], state, g, j)
        x, (k, v) = model.shared(x, e0, positions, kernels)
        kernels.write_prefix(cache["attn_k"], g, k)
        kernels.write_prefix(cache["attn_v"], g, v)
    for j, block in enumerate(model.tail):
        x, state = block(x, kernels)
        _store(cache["tail"], state, j)
    return _zamba_head(cfg, model, x[:, -1:], kernels), cache


def zamba_loss(cfg, model: ZambaLM, tokens, labels, remat: bool = True,
               kernels: Kernels = PLAIN):
    """(ce, ce), ``repro``'s ``zamba_loss``: with ``remat`` each Mamba2
    block and each application of the shared block keeps only its inputs
    for the backward, as ``repro`` checkpoints them. The shared block's
    weights are one set of bfloat16 parameters used once per group, so
    autograd adds their gradients in bfloat16 (``repro`` adds the float32
    casts of the same bfloat16 cotangents); the gradient tests count those
    additions in their bound."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = e0 = kernels.constrain(kernels.embed(model.embed, tokens))
    for group in model.groups:
        for block in group:
            x = run_layer(_hidden, block, x, kernels, remat=remat)
        x = run_layer(_hidden, model.shared, x, e0, positions, kernels, remat=remat)
    for block in model.tail:
        x = run_layer(_hidden, block, x, kernels, remat=remat)
    ce = kernels.cross_entropy(_zamba_head(cfg, model, x, kernels), labels)
    return ce, ce


def zamba_decode_step(cfg, model: ZambaLM, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at ``pos`` (an int or a 0-d int64 tensor on the token's
    device) → (logits [B, 1, V], cache updated in place): each Mamba2 state
    copied into its leaves, each KV cache written at ``pos``. No shape
    depends on ``pos`` and nothing reads it on the host, so a CUDA graph can
    replay the step."""
    pos = position(pos, token.device)
    x = e0 = kernels.constrain(kernels.embed(model.embed, token))
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group):
            x, state = block.decode(x, {n: t[g, j] for n, t in cache["groups"].items()},
                                    kernels)
            _store(cache["groups"], state, g, j)
        x = model.shared.decode(x, e0, cache["attn_k"][g], cache["attn_v"][g], pos, kernels)
    for j, block in enumerate(model.tail):
        x, state = block.decode(x, {n: t[j] for n, t in cache["tail"].items()}, kernels)
        _store(cache["tail"], state, j)
    return _zamba_head(cfg, model, x, kernels), cache
