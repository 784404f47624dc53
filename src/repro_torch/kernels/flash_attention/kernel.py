"""ctypes launcher of the CUDA flash attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py::_flash_kernel``. The
wrapper checks dtypes, shapes, devices and contiguity, allocates the output
with ``torch.empty``, launches on the current stream and raises on a launch
error. ``flash_attention_bkv_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

__all__ = ["flash_attention_bkv_cuda", "HEAD_DIMS"]

# The head widths each element type's kernel is built for: bfloat16 runs on
# the tensor cores (any multiple of 16 would do; these are the zoo's), float32
# on the CUDA cores.
HEAD_DIMS = {torch.bfloat16: (64, 112, 128), torch.float32: (64, 128)}
# The element types the kernel takes, by the code its C entry point reads.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_bkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, q_start: int = 0) -> torch.Tensor:
    """q: [BKV, Sq, G, hd]; k, v: [BKV, Sk, hd], all bfloat16 or all float32
    on one card, hd in ``HEAD_DIMS[dtype]`` → o like q; the same contract as
    :func:`.ref.attention_plain`. Any Sq and Sk ≥ 1; causal query row i sees
    the keys at positions ≤ ``q_start`` + i (``q_start`` ≥ 0)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bkv_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: expected bfloat16 or float32, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q [BKV, Sq, G, hd] and k, v [BKV, Sk, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bkv, sq, g, hd = (int(s) for s in q.shape)
    sk = int(k.shape[1])
    if k.shape[0] != bkv or k.shape[2] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {hd} not supported in {q.dtype}; the kernel takes "
                         + "; ".join(f"{t}: {dims}" for t, dims in HEAD_DIMS.items()))
    if sk < 1:
        raise ValueError("attention over zero keys")
    if q_start < 0:
        raise ValueError(f"q_start must be >= 0, got {q_start}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:  # 16-byte cp.async copies
            raise ValueError(f"{name}: must start on a 16-byte boundary")
    o = torch.empty_like(q)
    if bkv == 0 or sq == 0 or g == 0:
        return o
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bkv, sq, sk, g, hd,
            hd ** -0.5, int(causal), int(q_start), _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(lib, rc, "flash_attention launch")
        flash_attention_bkv_cuda.launches += 1
    return o


flash_attention_bkv_cuda.launches = 0
