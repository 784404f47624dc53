"""ctypes launchers of the CUDA window-CNN kernels (``csrc/conv_window.cu``).

Both replace ``repro/kernels/conv_window/kernel.py::_conv_window_kernel``:

* :func:`conv_window_frame_cuda` scores one window read straight from the
  normalized frame, one launch per head-count CNN task (the main path);
* :func:`conv_window_scores_cuda` scores a batch ``[N, 12, 12]``, the TPU
  kernel's own contract.

Each wrapper checks what guards its kernel, allocates the output with
``torch.empty``, launches on the current stream, raises on a launch error and
counts its launches (``.launches``). The head count calls the frame wrapper
5452 times a run around a kernel of a few microseconds, so its host path is
kept to that: no device context unless the frame's card is not the current
one, and the current stream's raw handle without building a ``Stream``.
"""

from __future__ import annotations

import torch

from .._build import check, load_library
from .ref import PACKED_LAYOUT

__all__ = ["conv_window_frame_cuda", "conv_window_scores_cuda", "PACKED_SIZE", "FRAME_SHAPE"]

PACKED_SIZE = PACKED_LAYOUT[-1][1] + 1   # 1265 floats of packed weights
FRAME_SHAPE = (60, 80)   # the Lepton frame the head count normalizes
_FRAME_SIZE = FRAME_SHAPE[0] * FRAME_SHAPE[1]

_SHAPES = {"w1": (3, 3, 1, 8), "b1": (8,), "w2": (3, 3, 8, 16), "b2": (16,),
           "fc": (16,), "fc_b": (1,)}


def _raw_stream(index: int) -> int:
    """The handle of the current stream on card ``index``: what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without building
    the ``Stream`` object (0.0004 against 0.006 ms a call on an H100)."""
    return torch._C._cuda_getCurrentRawStream(index)


def conv_window_frame_cuda(norm: torch.Tensor, packed_w: torch.Tensor, base: int,
                           row_stride: int, col_stride: int) -> torch.Tensor:
    """norm: the normalized frame, int32 [60, 80] on a card; packed_w: float32
    [1265] on the same card; the window's first element and its row and
    column strides in frame elements (:func:`.ops.window_offsets`) → a fresh
    0-dim float32 score; the same value as :func:`.ref.score_frame_window_plain`."""
    dev = norm.device
    if dev.type != "cuda":
        raise ValueError(f"conv_window_frame_cuda needs CUDA tensors, got {dev}")
    if norm.dtype != torch.int32 or norm.shape != FRAME_SHAPE or not norm.is_contiguous():
        raise ValueError(f"norm: expected a contiguous int32 {FRAME_SHAPE}, got "
                         f"{norm.dtype} {tuple(norm.shape)}")
    if (packed_w.dtype != torch.float32 or packed_w.shape != (PACKED_SIZE,)
            or packed_w.device != dev or not packed_w.is_contiguous()):
        raise ValueError(f"packed_w: expected a contiguous float32 ({PACKED_SIZE},) on {dev}, "
                         f"got {packed_w.dtype} {tuple(packed_w.shape)} on {packed_w.device}")
    if (base < 0 or row_stride < 1 or col_stride < 1
            or base + 11 * (row_stride + col_stride) >= _FRAME_SIZE):
        raise ValueError(f"window (base {base}, strides {row_stride}, {col_stride}) leaves "
                         f"the {FRAME_SHAPE} frame")
    out = torch.empty((), dtype=torch.float32, device=dev)
    lib = load_library()
    args = (norm.data_ptr(), packed_w.data_ptr(), out.data_ptr(), base, row_stride, col_stride)
    index = dev.index
    if index == torch.cuda.current_device():
        rc = lib.conv_window_frame_launch(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = lib.conv_window_frame_launch(*args, _raw_stream(index))
    if rc:
        check(lib, rc, "conv_window_frame launch")
    conv_window_frame_cuda.launches += 1
    return out


conv_window_frame_cuda.launches = 0


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
            _raw_stream(dev.index),
        )
        check(lib, rc, "conv_window launch")
        conv_window_scores_cuda.launches += 1
    return out


conv_window_scores_cuda.launches = 0
