"""Score image windows with the head-count CNN.

:func:`score_windows` is the counterpart of
``repro/kernels/conv_window/ops.py::score_windows``; :func:`score_frame_window`
is the head count's CNN task body, one window of the normalized frame (the
reference's jitted ``score_window``). Dispatch is on the tensor's device
alone: on a card the kernel runs (or the call raises); on the CPU the plain
version runs.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .kernel import conv_window_frame_cuda, conv_window_scores_cuda
from .ref import PACKED_LAYOUT, conv_window_scores_plain, score_frame_window_plain

__all__ = ["score_windows", "score_frame_window", "pack_cnn_weights", "window_offsets"]

_KEYS = tuple(name for name, _, _ in PACKED_LAYOUT)
_WIN = 12


def score_windows(windows, weights: Mapping[str, object]) -> torch.Tensor:
    """windows: [N, 12, 12] (a tensor, or numpy for the CPU); weights: the
    ``cnn_weights()`` dict (numpy or tensors, HWIO) → scores [N] float32 on
    the windows' device."""
    x = torch.as_tensor(windows, dtype=torch.float32).contiguous()
    dev = x.device
    w = [torch.as_tensor(weights[k], dtype=torch.float32, device=dev).contiguous()
         for k in _KEYS]
    run = conv_window_scores_cuda if dev.type == "cuda" else conv_window_scores_plain
    return run(x, *w)


def pack_cnn_weights(weights: Mapping[str, object], device=None) -> torch.Tensor:
    """The ``cnn_weights()`` dict (numpy or tensors, HWIO) → one contiguous
    float32 [1265] tensor in :data:`.ref.PACKED_LAYOUT` (the pieces end to
    end), on ``device`` (by default where the weights are)."""
    parts = [torch.as_tensor(weights[k], dtype=torch.float32, device=device).reshape(-1)
             for k in _KEYS]
    for (name, _, shape), p in zip(PACKED_LAYOUT, parts):
        if tuple(p.shape) != (int(np.prod(shape)),):
            raise ValueError(f"{name}: expected {shape}, got {p.numel()} elements")
    return torch.cat(parts)


def window_offsets(scale: int, y: int, x: int,
                   frame_shape: Tuple[int, int]) -> Tuple[int, int, int]:
    """(base, row_stride, col_stride) in elements of the row-major frame of
    the 12×12 window at (y, x) of the frame decimated by ``scale``
    (``frame[::scale, ::scale][y:y+12, x:x+12]``). Raises ``ValueError`` if
    the window leaves the decimated frame, so the kernel never reads out of
    bounds (``repro``'s ``dynamic_slice`` would clamp it instead)."""
    h, w = frame_shape
    hd, wd = (-(-h // scale), -(-w // scale)) if scale >= 1 else (0, 0)
    if y < 0 or x < 0 or y + _WIN > hd or x + _WIN > wd:
        raise ValueError(f"window (scale {scale}, y {y}, x {x}) leaves the {hd}x{wd} "
                         f"decimated frame")
    return y * scale * w + x * scale, scale * w, scale


def score_frame_window(norm: torch.Tensor, packed_w: torch.Tensor, scale: int, y: int, x: int,
                       offsets: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The 12×12 window at (y, x) of the normalized frame (int32 [60, 80])
    decimated by ``scale``, scored with the packed weights → 0-dim float32 on
    the frame's device. ``offsets`` is :func:`window_offsets` of the window,
    when the caller has it already."""
    if offsets is None:
        offsets = window_offsets(scale, y, x, tuple(norm.shape))
    if norm.device.type != "cuda":
        return score_frame_window_plain(norm, packed_w, scale, y, x)
    return conv_window_frame_cuda(norm, packed_w, *offsets)
