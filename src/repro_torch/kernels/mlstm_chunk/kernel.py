"""ctypes launcher of the CUDA chunked mLSTM kernel (``csrc/mlstm_chunk.cu``).

Replaces ``repro/kernels/mlstm_chunk/kernel.py::_mlstm_kernel``. The wrapper
checks dtypes, shapes, devices and contiguity, allocates the outputs and the
kernel's scratch with ``torch.empty``, launches on the current stream and
raises on a launch error. ``mlstm_chunk_bh_cuda.launches`` counts launches
(one per call: the kernel's three stages run as one launch sequence).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, load_library
from .ref import chunk_len

__all__ = ["mlstm_chunk_bh_cuda", "MAX_CHUNK", "HEAD_DIM_MULTIPLE", "MAX_HEAD_DIM_BF16"]

MAX_CHUNK = 128
HEAD_DIM_MULTIPLE = 32
# The bfloat16 kernel keeps 32 columns of C^T in the registers of 16 warps,
# two 32-wide d groups a warp (csrc/mlstm_chunk.cu, tc::kMaxHd).
MAX_HEAD_DIM_BF16 = 1024
# The element types the kernel takes, by the code its C entry point reads.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mlstm_chunk_bh_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor, *, chunk: int = 128
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """q/k/v: [BH, S, hd], all bfloat16 or all float32, hd a multiple of 32;
    i_pre/f_pre: [BH, S] float32; all on one card → (y [BH, S, hd] like q,
    (C [BH, hd, hd], n [BH, hd], m [BH]) float32); the same contract as
    :func:`.ref.mlstm_chunk_plain`. ``chunk`` at most 128. bfloat16 takes a
    head dim up to 1024 and tensors that start on 16 bytes; in float32 a
    head dim whose slice of C does not fit in the card's shared memory
    (above 1472 on an H100) fails at launch and raises."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mlstm_chunk_bh_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected bfloat16 or float32, got {q.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v [BH, S, hd] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = (int(x) for x in q.shape)
    if i_pre.shape != (bh, s) or f_pre.shape != (bh, s):
        raise ValueError(f"expected gates [{bh}, {s}], got {tuple(i_pre.shape)} and "
                         f"{tuple(f_pre.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    L = chunk_len(s, chunk)
    if hd % HEAD_DIM_MULTIPLE:
        raise ValueError(f"head dim {hd} is not a multiple of {HEAD_DIM_MULTIPLE}")
    if q.dtype == torch.bfloat16 and hd > MAX_HEAD_DIM_BF16:
        raise ValueError(f"head dim {hd} above {MAX_HEAD_DIM_BF16}, the most the bfloat16 "
                         "kernel holds")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype),
                           ("i_pre", i_pre, torch.float32), ("f_pre", f_pre, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: a bfloat16 tensor must start on 16 bytes")
    lib = load_library()
    y = torch.empty_like(q)
    C = torch.empty(bh, hd, hd, dtype=torch.float32, device=dev)
    n = torch.empty(bh, hd, dtype=torch.float32, device=dev)
    m = torch.empty(bh, dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.mlstm_chunk_scratch_floats(bh, s, L), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(), f_pre.data_ptr(),
            y.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(), scratch.data_ptr(),
            bh, s, hd, L, _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream,
        )
        check(lib, rc, "mlstm_chunk launch")
        mlstm_chunk_bh_cuda.launches += 1
    return y, (C, n, m)


mlstm_chunk_bh_cuda.launches = 0
