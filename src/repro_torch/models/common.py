"""Shared model components: dtype policy, norms, RoPE, initializers, and the
pair of kernel-backed functions a model runs through.

Numerics policy as in ``repro/models/common.py``: parameters are made in
float32; activations and matmuls run in bfloat16; norm statistics, RoPE and
softmax statistics in float32. The port stores each matmul weight once in
bfloat16 (``repro`` casts the float32 weight at every use, which gives the
same bfloat16 value every time); norm weights stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch import nn

from ..kernels.flash_attention import ops as attention_ops
from ..kernels.flash_attention.ops import from_bkv, to_bkv
from ..kernels.flash_attention.ref import attention_plain
from ..kernels.mlstm_chunk import ops as mlstm_ops
from ..kernels.mlstm_chunk.ref import mlstm_chunk_plain
from ..kernels.rmsnorm import ops as rmsnorm_ops
from ..kernels.rmsnorm.ref import rmsnorm_plain

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32
NEG_INF = -1e30  # the masked scores' fill, as repro/models/attention.py has it

__all__ = [
    "COMPUTE_DTYPE", "PARAM_DTYPE", "NEG_INF", "Kernels", "KERNELS", "PLAIN", "dense_init",
    "ones_init", "frozen", "rmsnorm", "apply_rope", "position",
]


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The model's kernel-backed functions, swapped together.

    ``rmsnorm(x, w, eps)`` → like x; ``attention(q, k, v, causal)`` in the
    model layout ``[B, S, H, hd]`` / ``[B, S, KV, hd]``; ``mlstm(q, k, v,
    i_pre, f_pre)`` → (y, (C, n, m)), the chunked mLSTM cell from the zero
    state in the layout of :func:`..kernels.mlstm_chunk.ops.mlstm_cell`.
    :data:`KERNELS`
    dispatches on the tensors' device (the CUDA kernels on a card, the plain
    versions on the CPU); :data:`PLAIN` runs the plain versions on any
    device and is the kernels' referee on the card.
    """

    rmsnorm: Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]
    attention: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool], torch.Tensor]
    mlstm: Callable


def _kernel_attention(q, k, v, causal):
    return attention_ops.flash_attention(q, k, v, causal=causal)


def _plain_attention(q, k, v, causal):
    return from_bkv(attention_plain(*to_bkv(q, k, v), causal=causal), q.shape[0])


def _plain_mlstm(q, k, v, i_pre, f_pre):
    return mlstm_ops.in_model_layout(mlstm_chunk_plain, q, k, v, i_pre, f_pre)


KERNELS = Kernels(rmsnorm=rmsnorm_ops.rmsnorm, attention=_kernel_attention,
                  mlstm=mlstm_ops.mlstm_cell)
PLAIN = Kernels(rmsnorm=rmsnorm_plain, attention=_plain_attention, mlstm=_plain_mlstm)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale²) in float32 on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=PARAM_DTYPE) * scale


def ones_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.ones(shape, device=gen.device, dtype=PARAM_DTYPE)


def frozen(t: torch.Tensor, dtype: torch.dtype) -> nn.Parameter:
    """An inference-only parameter holding ``t`` cast to ``dtype``."""
    return nn.Parameter(t.to(dtype), requires_grad=False)


def rmsnorm(x, w, eps: float = 1e-5, kernels: Kernels = KERNELS) -> torch.Tensor:
    """RMSNorm over the last axis; the result is in ``COMPUTE_DTYPE``."""
    return kernels.rmsnorm(x, w, eps).to(COMPUTE_DTYPE)


def _rope_angles(positions, head_dim: int, theta: float):
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, exponent)  # a Python scalar base: no host-to-device copy
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates in
    float32 and casts back to x's dtype."""
    sin, cos = _rope_angles(positions, x.shape[-1], theta)
    sin, cos = sin[..., None, :], cos[..., None, :]  # broadcast over heads
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def position(pos, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a tensor
    passes through (a CUDA graph's static input), a Python int is filled in
    on the device (no host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((), int(pos), dtype=torch.int64, device=device)
