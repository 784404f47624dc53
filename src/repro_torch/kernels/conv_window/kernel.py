"""ctypes launcher of the CUDA window-CNN kernel (``csrc/conv_window.cu``).

Replaces ``repro/kernels/conv_window/kernel.py::_conv_window_kernel``. The
wrapper checks dtypes, shapes, devices and contiguity, allocates the scores
with ``torch.empty``, launches on the current stream and raises on a launch
error. ``conv_window_scores_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .._build import check, load_library

__all__ = ["conv_window_scores_cuda"]

_SHAPES = {"w1": (3, 3, 1, 8), "b1": (8,), "w2": (3, 3, 8, 16), "b2": (16,),
           "fc": (16,), "fc_b": (1,)}


def conv_window_scores_cuda(windows, w1, b1, w2, b2, fc, fc_b) -> torch.Tensor:
    """windows: [N, 12, 12] float32 on a card → scores [N] float32; the
    same contract as :func:`.ref.conv_window_scores_plain`."""
    dev = windows.device
    if dev.type != "cuda":
        raise ValueError(f"conv_window_scores_cuda needs CUDA tensors, got {dev}")
    fc_b = fc_b.reshape(1)
    if windows.dim() != 3 or tuple(windows.shape[1:]) != (12, 12):
        raise ValueError(f"windows: expected [N, 12, 12], got {tuple(windows.shape)}")
    named = {"windows": windows, "w1": w1, "b1": b1, "w2": w2, "b2": b2,
             "fc": fc, "fc_b": fc_b}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if name in _SHAPES and tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"{name}: expected {_SHAPES[name]}, got {tuple(t.shape)}")
    n = int(windows.shape[0])
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.conv_window_launch(
            windows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), fc.data_ptr(), fc_b.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        check(lib, rc, "conv_window launch")
        conv_window_scores_cuda.launches += 1
    return out


conv_window_scores_cuda.launches = 0
