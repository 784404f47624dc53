"""Recurrent LM assemblies (``repro/models/recurrent.py``): the xLSTM half.

xlstm-1.3b: blocks in groups of ``slstm_every``, (slstm_every − 1) mLSTM
blocks followed by one sLSTM block, each block pre-normed and residual. 48
layers = 6 groups of 7 mLSTM + 1 sLSTM. ``repro`` scans over the stacked
groups; here they are nested ``nn.ModuleList``s run by plain loops. The
"cache" is the recurrent state, O(1) in sequence length, stacked as the
reference stacks it: mLSTM states [G, n_m, B, ...], sLSTM states [G, B, ...],
all float32, updated in place by each decode step. Zamba2 (the hybrid half)
waits for its slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, Kernels, dense_init, frozen,
                     ones_init)
from .xlstm import (MLSTMCell, SLSTMCell, init_mlstm, init_slstm, mlstm_dims, slstm_dims)

__all__ = ["XLSTMLM", "init_xlstm_lm", "xlstm_groups", "xlstm_prefill", "xlstm_decode_step",
           "xlstm_cache_shape"]


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
        return x + y, state

    def decode(self, x, state, kernels: Kernels = KERNELS):
        y, state = self.cell.decode(kernels.rmsnorm(x, self.ln, self.cfg.norm_eps), state)
        return x + y, state


class XLSTMGroup(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.cfg = cfg
        self.m = nn.ModuleList(MLSTMBlock(cfg, bp) for bp in p["m"])
        self.s = SLSTMCell(cfg, p["s"])
        self.s_ln = frozen(p["s_ln"], PARAM_DTYPE)

    def slstm(self, x, state, kernels: Kernels = KERNELS):
        y, state = self.s(kernels.rmsnorm(x, self.s_ln, self.cfg.norm_eps), state)
        return x + y, state


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


def xlstm_prefill(cfg, model: XLSTMLM, tokens, max_seq: int, kernels: Kernels = KERNELS):
    """tokens [B, S] → (logits of the last position [B, 1, V], cache): every
    block from the zero state, its final state written into the cache."""
    cache = {part: {name: torch.empty(shape, dtype=dtype, device=tokens.device)
                    for name, (shape, dtype) in names.items()}
             for part, names in xlstm_cache_shape(cfg, tokens.shape[0], max_seq).items()}
    x = model.embed[tokens]
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group.m):
            x, state = block(x, kernels)
            for name, t in state.items():
                cache["m"][name][g, j] = t
        x, state = group.slstm(x, None, kernels)
        for name, t in state.items():
            cache["s"][name][g] = t
    return _head(cfg, model, x[:, -1:], kernels), cache


def xlstm_decode_step(cfg, model: XLSTMLM, cache, token, pos,
                      kernels: Kernels = KERNELS):
    """token [B, 1] → (logits [B, 1, V], cache updated in place). ``pos`` (an
    int or a 0-d tensor) is not used: the recurrent state carries the
    position, and every shape is static."""
    del pos
    x = model.embed[token]
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group.m):
            x, state = block.decode(x, {n: t[g, j] for n, t in cache["m"].items()}, kernels)
            for name, t in state.items():
                cache["m"][name][g, j] = t
        x, state = group.slstm(x, {n: t[g] for n, t in cache["s"].items()}, kernels)
        for name, t in state.items():
            cache["s"][name][g] = t
    return _head(cfg, model, x, kernels), cache
