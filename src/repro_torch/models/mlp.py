"""Gated SwiGLU feed-forward block (``repro/models/mlp.py::swiglu``)."""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .common import COMPUTE_DTYPE, dense_init, frozen

__all__ = ["SwiGLU", "init_swiglu"]


def init_swiglu(cfg, gen) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, (d, ff)),   # gate
            "w3": dense_init(gen, (d, ff)),   # up
            "w2": dense_init(gen, (ff, d))}   # down


class SwiGLU(nn.Module):
    """silu(x W1) ⊙ (x W3) W2; the silu in float32, everything else bf16."""

    def __init__(self, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.w1 = frozen(p["w1"], COMPUTE_DTYPE)
        self.w3 = frozen(p["w3"], COMPUTE_DTYPE)
        self.w2 = frozen(p["w2"], COMPUTE_DTYPE)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x @ self.w1
        u = x @ self.w3
        h = F.silu(g.to(torch.float32)).to(COMPUTE_DTYPE) * u
        return h @ self.w2
