"""ctypes launcher of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel``. The wrapper
checks dtypes, shapes, devices and contiguity, allocates the output with
``torch.empty``, launches on the current stream and raises on a launch
error. ``rmsnorm_rows_cuda.launches`` counts launches.

The model calls it 145 times a qwen3-4b decode step around a kernel of a few
microseconds, so its host path is kept to what guards the kernel: no
reshape (the rows are all of x's leading dims), no device context unless
x's card is not the current one, and the current stream without a device
lookup.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

__all__ = ["rmsnorm_rows_cuda"]

# The element types the kernel takes, by the code its C entry point reads.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_rows_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d] bfloat16 or float32 on a card, its rows the leading dims;
    w: [d] float32 → like x; the same contract as :func:`.ref.rmsnorm_plain`."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_rows_cuda needs CUDA tensors, got {dev}")
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise TypeError(f"x: expected bfloat16 or float32, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w: expected torch.float32, got {w.dtype}")
    shape = x.shape
    if not shape or w.shape != shape[-1:]:
        raise ValueError(f"expected x [..., d] and w [d], got {tuple(shape)} and "
                         f"{tuple(w.shape)}")
    if w.device != dev:
        raise ValueError(f"w: expected a tensor on {dev}, got {w.device}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if not w.is_contiguous():
        raise ValueError("w: must be contiguous")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = load_library()
    d = shape[-1]
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), y.numel() // d, d, eps, code)
    if dev.index == torch.cuda.current_device():
        rc = lib.rmsnorm_launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.rmsnorm_launch(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        check(lib, rc, "rmsnorm launch")
    rmsnorm_rows_cuda.launches += 1
    return y


rmsnorm_rows_cuda.launches = 0
