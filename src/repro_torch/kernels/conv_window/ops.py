"""Score image windows with the head-count CNN weights dict.

The counterpart of ``repro/kernels/conv_window/ops.py::score_windows``.
Dispatch is on the device alone: on a CUDA device the kernel runs (or the
call raises); on the CPU the plain version runs.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ...device import resolve_device
from .kernel import conv_window_scores_cuda
from .ref import conv_window_scores_plain

__all__ = ["score_windows"]

_KEYS = ("conv1", "b1", "conv2", "b2", "fc", "fc_b")


def score_windows(windows, weights: Mapping[str, object], *, device="cuda") -> torch.Tensor:
    """windows: [N, 12, 12]; weights: the ``cnn_weights()`` dict (numpy or
    tensors, HWIO) → scores [N] float32 on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(windows, dtype=torch.float32, device=dev).contiguous()
    w = [torch.as_tensor(weights[k], dtype=torch.float32, device=dev).contiguous()
         for k in _KEYS]
    run = conv_window_scores_cuda if dev.type == "cuda" else conv_window_scores_plain
    return run(x, *w)
