"""Feed-forward blocks (``repro/models/mlp.py``): gated SwiGLU (llama
family) and the GELU MLP with biases (whisper)."""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .common import COMPUTE_DTYPE, KERNELS, Kernels, dense_init, frozen, zeros_init

__all__ = ["SwiGLU", "init_swiglu", "GeluMLP", "init_gelu_mlp"]


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

    def forward(self, x: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
        g = kernels.matmul(x, self.w1)
        u = kernels.matmul(x, self.w3)
        h = F.silu(g.to(torch.float32)).to(COMPUTE_DTYPE) * u
        return kernels.matmul(h, self.w2)


def init_gelu_mlp(cfg, gen) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, (d, ff)), "b1": zeros_init(gen, (ff,)),
            "w2": dense_init(gen, (ff, d)), "b2": zeros_init(gen, (d,))}


class GeluMLP(nn.Module):
    """gelu(x W1 + b1) W2 + b2; the biases added in bf16, the GELU the tanh
    approximation (``jax.nn.gelu``'s default) in float32, then rounded to
    bf16, as ``repro`` does."""

    def __init__(self, p: Mapping[str, torch.Tensor]):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))

    def forward(self, x: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
        h = kernels.matmul(x, self.w1) + self.b1
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(COMPUTE_DTYPE)
        return kernels.matmul(h, self.w2) + self.b2
