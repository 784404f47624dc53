"""Model API: one entry point each for init / prefill / decode, dispatched
on ``cfg.family`` (``repro/models/api.py``), plus :func:`params_from_numpy`,
which carries the reference's parameters across.

Only the dense family is ported; the others raise, naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device
from . import transformer
from .common import KERNELS, Kernels

__all__ = ["init_params", "params_from_numpy", "prefill", "decode_step", "cache_shape"]


def _check_ported(cfg) -> None:
    if cfg.family in ("dense", "moe", "vlm"):
        return  # the transformer module raises for what it does not run yet
    raise NotImplementedError(
        f"the {cfg.family} family is not ported yet: ROADMAP.md queue 1, model zoo")


def init_params(cfg, seed: int = 0, device="cuda") -> transformer.DenseLM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the numbers differ from ``repro``'s ``PRNGKey(seed)``; use
    :func:`params_from_numpy` to run the reference's parameters)."""
    _check_ported(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    with torch.no_grad():
        return transformer.init_lm(cfg, gen)


def params_from_numpy(cfg, tree: Mapping[str, Any], device="cuda") -> transformer.DenseLM:
    """``repro``'s parameter tree (``init_params(cfg, key)[0]``) as nested
    dicts of numpy arrays, layers stacked on axis 0 → the port's model."""
    _check_ported(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

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


def prefill(cfg, params, batch: Dict[str, torch.Tensor], max_seq: int,
            kernels: Kernels = KERNELS):
    """batch {"tokens": [B, S]} → (logits [B, 1, V], cache)."""
    _check_ported(cfg)
    with torch.no_grad():
        return transformer.lm_prefill(cfg, params, batch["tokens"], max_seq, kernels)


def decode_step(cfg, params, cache, token, pos: int, kernels: Kernels = KERNELS):
    """token [B, 1] at ``pos`` → (logits [B, 1, V], cache updated in place)."""
    _check_ported(cfg)
    with torch.no_grad():
        return transformer.lm_decode_step(cfg, params, cache, token, pos, kernels)


def cache_shape(cfg, batch: int, max_seq: int):
    _check_ported(cfg)
    return transformer.lm_cache_shape(cfg, batch, max_seq)
