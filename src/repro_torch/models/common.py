"""Shared model components: dtype policy, norms, RoPE, initializers, and the
pair of kernel-backed functions a model runs through.

Numerics policy as in ``repro/models/common.py``: parameters are made in
float32; activations and matmuls run in bfloat16; norm statistics, RoPE and
softmax statistics in float32. The port stores each matmul weight once in
bfloat16 (``repro`` casts the float32 weight at every use, which gives the
same bfloat16 value every time); norm weights stay float32.

Training keeps ``repro``'s float32 parameters as masters beside the module
(``recording_sources`` gives each parameter's float32 source), takes the
loss through :data:`PLAIN` under autograd (``softmax_cross_entropy``), and
rematerializes where ``repro`` does (``run_layer``).

A model built without numbers (on ``meta``, :class:`AbstractGenerator`)
runs through :data:`COUNTED`, the kernels' stand-ins, when a step is
counted rather than run (``launch/roofline.py``).

Sharded over a mesh (``models/sharding.py``, ``launch/steps.py``), a model's
parameters and inputs are DTensors and it runs through
``sharding.sharded``'s bundle: each kernel under ``local_map`` on each
device's block, and the bundle's layout fields (:class:`Kernels`) where the
mesh decides how an operation runs; the model code is the same.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import operator
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    "COMPUTE_DTYPE", "PARAM_DTYPE", "NEG_INF", "Kernels", "KERNELS", "PLAIN", "COUNTED",
    "AbstractGenerator", "dense_init",
    "ones_init", "zeros_init", "frozen", "recording_sources", "rmsnorm", "layernorm",
    "apply_rope", "position", "softmax_cross_entropy", "run_layer",
]


def _as_is(x, *logical):
    return x


def _heads(y, n_heads: int, head_dim: int) -> torch.Tensor:
    return y.unflatten(-1, (n_heads, head_dim))


def _embed(w, tokens) -> torch.Tensor:
    return w[tokens]


def _new_cache(shapes, like, logical=None, make=torch.zeros):
    if shapes is None:
        return None
    if isinstance(shapes, dict):
        return {k: _new_cache(v, like, None, make) for k, v in shapes.items()}
    shape, dtype = shapes
    return make(shape, dtype=dtype, device=like.device)


def _write_prefix(cache, i: int, kv) -> None:
    cache[i, :, :kv.shape[1]] = kv


def _write_at(cache, pos, new) -> None:
    cache.index_copy_(1, pos.view(1), new)


def _whole(fn, module, *args, means=(), weights=None):
    return fn(*args)


def _decode_attention(fn, q, cache_k, cache_v, visible):
    return fn(q, cache_k, cache_v, visible)


def _experts(moe, x, means: bool = False):
    return moe._block(x, means)


def _ssd(cell, x, state=None, decode: bool = False):
    return cell.decode(x, state) if decode else cell(x, state)


def _cross_entropy(logits, labels) -> torch.Tensor:
    # this module's function as it is at each call, so that a test can wrap
    # it to read the logits every loss takes
    return softmax_cross_entropy(logits, labels)


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The model's kernel-backed functions, swapped together, and the
    operations whose layout a mesh decides.

    ``rmsnorm(x, w, eps)`` → like x; ``attention(q, k, v, causal,
    q_start=0)`` in the model layout ``[B, S, H, hd]`` / ``[B, S, KV, hd]``
    (q the rows from position ``q_start`` on of a sequence k and v hold
    whole); ``mlstm(q, k, v,
    i_pre, f_pre)`` → (y, (C, n, m)), the chunked mLSTM cell from the zero
    state in the layout of :func:`..kernels.mlstm_chunk.ops.mlstm_cell`.
    :data:`KERNELS`
    dispatches on the tensors' device (the CUDA kernels on a card, the plain
    versions on the CPU); :data:`PLAIN` runs the plain versions on any
    device and is the kernels' referee on the card; :data:`COUNTED` runs on
    ``meta`` only, each function adding its kernel's work to an open count
    and returning empty outputs of the kernel's shapes and types (it raises
    on any other device).

    The other fields are the plain tensor code by default, in every bundle
    here; ``sharding.sharded`` fills them for DTensors on a mesh:
    ``constrain(x)`` lays an activation out at ``repro``'s sites (its
    ``make_constrain``) and ``layout(x, *logical)`` by the logical axes
    given, both the identity here; ``matmul(x, w)``; ``heads(y, n_heads,
    head_dim)`` splits a projection's last dim into heads;
    ``embed(w, tokens)`` the table's rows; ``new_cache(shapes, like,
    logical, make)`` a cache tree from its {leaf: (shape, dtype)} tree on
    ``like``'s device (None stays None; ``logical`` the cache's logical
    axes); ``write_prefix(cache, i, kv)`` is ``cache[i, :, :S] = kv``,
    ``write_at(cache, pos, new)`` is ``cache[:, pos] = new[:, 0]`` in place;
    ``cross_entropy(logits, labels)`` is :func:`softmax_cross_entropy`;
    ``local(fn, module, *args, means=(), weights=None)`` is ``fn(*args)`` (on
    a mesh, on each device's batch block, ``module``'s parameters named in
    ``weights`` gathered whole, all of them by default); ``decode_attention(fn, q, cache_k, cache_v,
    visible)`` is ``fn(q, cache_k, cache_v, visible)``; ``experts(moe, x,
    means=False)`` is the MoE block ``moe._block(x, means)`` (on a mesh,
    each device its own experts); ``ssd(cell, x, state=None, decode=False)``
    is the Mamba2 cell's prefill ``cell(x, state)`` or step ``cell.decode(x,
    state)`` (on a mesh, each device its heads).
    """

    rmsnorm: Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]
    attention: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool], torch.Tensor]
    mlstm: Callable
    constrain: Callable[[torch.Tensor], torch.Tensor] = _as_is
    layout: Callable = _as_is
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = operator.matmul
    heads: Callable = _heads
    embed: Callable = _embed
    new_cache: Callable = _new_cache
    write_prefix: Callable = _write_prefix
    write_at: Callable = _write_at
    cross_entropy: Callable = _cross_entropy
    local: Callable = _whole
    decode_attention: Callable = _decode_attention
    experts: Callable = _experts
    ssd: Callable = _ssd


def _kernel_attention(q, k, v, causal, q_start=0):
    return attention_ops.flash_attention(q, k, v, causal=causal, q_start=q_start)


def _plain_attention(q, k, v, causal, q_start=0):
    return from_bkv(attention_plain(*to_bkv(q, k, v), causal=causal, q_start=q_start),
                    q.shape[0])


def _plain_mlstm(q, k, v, i_pre, f_pre):
    return mlstm_ops.in_model_layout(mlstm_chunk_plain, q, k, v, i_pre, f_pre)


def _counted_attention(q, k, v, causal, q_start=0):
    return attention_ops.flash_attention_counted(q, k, v, causal=causal, q_start=q_start)


KERNELS = Kernels(rmsnorm=rmsnorm_ops.rmsnorm, attention=_kernel_attention,
                  mlstm=mlstm_ops.mlstm_cell)
PLAIN = Kernels(rmsnorm=rmsnorm_plain, attention=_plain_attention, mlstm=_plain_mlstm)
COUNTED = Kernels(rmsnorm=rmsnorm_ops.rmsnorm_counted, attention=_counted_attention,
                  mlstm=mlstm_ops.mlstm_cell_counted)


class AbstractGenerator:
    """Stands in for a ``torch.Generator`` when a model is built without
    numbers: the initializers make empty ``meta`` tensors of the same
    shapes and types (a generator cannot live on ``meta``)."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale²) in float32 on the generator's device (empty on
    ``meta``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, device=gen.device, dtype=PARAM_DTYPE)
    return torch.randn(shape, generator=gen, device=gen.device, dtype=PARAM_DTYPE) * scale


def ones_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.ones(shape, device=gen.device, dtype=PARAM_DTYPE)


def zeros_init(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    return torch.zeros(shape, device=gen.device, dtype=PARAM_DTYPE)


_SOURCES: contextvars.ContextVar[Optional[Dict[nn.Parameter, torch.Tensor]]] = (
    contextvars.ContextVar("frozen_sources", default=None))


def frozen(t: torch.Tensor, dtype: torch.dtype) -> nn.Parameter:
    """An inference-only parameter holding ``t`` cast to ``dtype``; inside
    :func:`recording_sources`, ``t`` is also kept, keyed by the parameter."""
    p = nn.Parameter(t.to(dtype), requires_grad=False)
    sources = _SOURCES.get()
    if sources is not None:
        sources[p] = t
    return p


@contextlib.contextmanager
def recording_sources() -> Iterator[Dict[nn.Parameter, torch.Tensor]]:
    """{parameter: the tensor it was cast from}, filled by every
    :func:`frozen` call inside the block in this thread: a model built from
    a float32 tree in it yields the tree's unrounded values by parameter."""
    sources: Dict[nn.Parameter, torch.Tensor] = {}
    token = _SOURCES.set(sources)
    try:
        yield sources
    finally:
        _SOURCES.reset(token)


def rmsnorm(x, w, eps: float = 1e-5, kernels: Kernels = KERNELS) -> torch.Tensor:
    """RMSNorm over the last axis; the result is in ``COMPUTE_DTYPE``."""
    return kernels.rmsnorm(x, w, eps).to(COMPUTE_DTYPE)


def layernorm(x, w, b, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (``repro``'s ``layernorm``;
    plain tensor code in both packages); the result is in ``COMPUTE_DTYPE``.
    ``jnp.var`` is the population variance: ``correction=0``."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(COMPUTE_DTYPE)


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


def softmax_cross_entropy(logits, labels) -> torch.Tensor:
    """Mean token cross-entropy, ``repro``'s: logits [..., V] of any type
    in float32, logsumexp minus the label's logit, then the mean."""
    logits = logits.to(torch.float32)
    picked = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def run_layer(fn, *args, remat: bool):
    """``fn(*args)``; with ``remat``, under non-reentrant activation
    checkpointing, which keeps only the inputs and runs ``fn`` again in the
    backward: ``repro``'s ``jax.checkpoint(policy=nothing_saveable)`` over
    the same body. The body reads no random numbers."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)
