"""Plain PyTorch version of the window CNN (the same math as
``repro/kernels/conv_window/ref.py`` and the head-count app's
``_jax_kernels().score_window``), float32, HWIO weights."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv_window_scores_plain"]


def conv_window_scores_plain(windows, w1, b1, w2, b2, fc, fc_b) -> torch.Tensor:
    """windows: [N, 12, 12] → scores [N], float32.

    On a card, cuDNN would run the convolutions in TF32 by default; this
    version pins full float32 for the duration of the call.
    """
    with torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False
    ):
        x = windows.to(torch.float32)[:, None]                    # [N,1,12,12]
        x = F.conv2d(x, w1.permute(3, 2, 0, 1)) + b1[None, :, None, None]
        x = F.max_pool2d(F.relu(x), 2)                            # [N,8,5,5]
        x = F.conv2d(x, w2.permute(3, 2, 0, 1)) + b2[None, :, None, None]
        feat = F.relu(x).mean(dim=(2, 3))                         # [N,16]
    return (feat * fc[None, :]).sum(dim=1) + fc_b
