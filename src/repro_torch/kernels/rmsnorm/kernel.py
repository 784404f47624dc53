"""ctypes launcher of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel``. The wrapper
checks dtypes, shapes, devices and contiguity, allocates the output with
``torch.empty``, launches on the current stream and raises on a launch
error. ``rmsnorm_rows_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

__all__ = ["rmsnorm_rows_cuda"]

# The element types the kernel takes, by the code its C entry point reads.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_rows_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [N, d] bfloat16 or float32 on a card; w: [d] float32 → [N, d] like
    x; the same contract as :func:`.ref.rmsnorm_plain`."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_rows_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w: expected torch.float32, got {w.dtype}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"expected x [N, d] and w [d], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    n, d = (int(s) for s in x.shape)
    y = torch.empty_like(x)
    if n == 0 or d == 0:
        return y
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d,
                                float(eps), _DTYPES[x.dtype],
                                torch.cuda.current_stream(dev).cuda_stream)
        check(lib, rc, "rmsnorm launch")
        rmsnorm_rows_cuda.launches += 1
    return y


rmsnorm_rows_cuda.launches = 0
