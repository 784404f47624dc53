"""Model API: one entry point each for init / prefill / decode, dispatched
on ``cfg.family`` (``repro/models/api.py``), plus :func:`params_from_numpy`,
which carries the reference's parameters across.

Ported: the dense family (``transformer``) and the ssm family, xLSTM
(``recurrent``); the others raise, naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device
from . import recurrent, transformer
from .common import KERNELS, Kernels

__all__ = ["init_params", "params_from_numpy", "prefill", "decode_step", "cache_shape"]


def _module(cfg):
    """The module that runs ``cfg``'s family."""
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer  # it raises for what it does not run yet
    if cfg.family == "ssm":
        return recurrent
    raise NotImplementedError(
        f"the {cfg.family} family is not ported yet: ROADMAP.md queue 1, model zoo")


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the numbers differ from ``repro``'s ``PRNGKey(seed)``; use
    :func:`params_from_numpy` to run the reference's parameters)."""
    module = _module(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    with torch.no_grad():
        if module is recurrent:
            return recurrent.init_xlstm_lm(cfg, gen)
        return transformer.init_lm(cfg, gen)


def params_from_numpy(cfg, tree: Mapping[str, Any], device="cuda"):
    """``repro``'s parameter tree (``init_params(cfg, key)[0]``) as nested
    dicts of numpy arrays → the port's model. Dense: layers stacked on axis
    0. xLSTM: ``groups.m`` stacked [groups, blocks, ...], ``groups.s`` and
    ``groups.s_ln`` stacked [groups, ...]."""
    module = _module(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    if module is recurrent:
        return _xlstm_from_numpy(cfg, tree, t)
    stacked = tree["layers"]

    def layer(i):
        return {"ln1": t(stacked["ln1"][i]), "ln2": t(stacked["ln2"][i]),
                "attn": {k: t(a[i]) for k, a in stacked["attn"].items()},
                "mlp": {k: t(a[i]) for k, a in stacked["mlp"].items()}}

    with torch.no_grad():
        return transformer.DenseLM(cfg, {
            "embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
            "head": t(tree["head"]), "layers": (layer(i) for i in range(cfg.n_layers)),
        })


def _xlstm_from_numpy(cfg, tree, t):
    n_groups, n_m = recurrent.xlstm_groups(cfg)
    g = tree["groups"]

    def group(i):
        return {"m": [{"cell": {k: t(a[i, j]) for k, a in g["m"]["cell"].items()},
                       "ln": t(g["m"]["ln"][i, j])} for j in range(n_m)],
                "s": {k: t(a[i]) for k, a in g["s"].items()}, "s_ln": t(g["s_ln"][i])}

    with torch.no_grad():
        return recurrent.XLSTMLM(cfg, {
            "embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
            "head": t(tree["head"]), "groups": (group(i) for i in range(n_groups)),
        })


def prefill(cfg, params, batch: Dict[str, torch.Tensor], max_seq: int,
            kernels: Kernels = KERNELS):
    """batch {"tokens": [B, S]} → (logits [B, 1, V], cache)."""
    module = _module(cfg)
    with torch.no_grad():
        if module is recurrent:
            return recurrent.xlstm_prefill(cfg, params, batch["tokens"], max_seq, kernels)
        return transformer.lm_prefill(cfg, params, batch["tokens"], max_seq, kernels)


def decode_step(cfg, params, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at ``pos`` (an int, or a 0-d int64 tensor on the token's
    device) → (logits [B, 1, V], cache updated in place). No shape depends
    on ``pos`` and nothing reads it on the host, so a CUDA graph can replay
    the step."""
    module = _module(cfg)
    with torch.no_grad():
        if module is recurrent:
            return recurrent.xlstm_decode_step(cfg, params, cache, token, pos, kernels)
        return transformer.lm_decode_step(cfg, params, cache, token, pos, kernels)


def cache_shape(cfg, batch: int, max_seq: int):
    if _module(cfg) is recurrent:
        return recurrent.xlstm_cache_shape(cfg, batch, max_seq)
    return transformer.lm_cache_shape(cfg, batch, max_seq)
