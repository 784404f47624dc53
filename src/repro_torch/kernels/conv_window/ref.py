"""Plain PyTorch version of the window CNN (the same math as
``repro/kernels/conv_window/ref.py`` and the head-count app's
``_jax_kernels().score_window``), float32, HWIO weights."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["PACKED_LAYOUT", "conv_window_scores_plain", "unpack_cnn_weights",
           "score_frame_window_plain"]

# The packed weight buffer of the frame kernel: (name, offset, shape), in
# the order of the ``cnn_weights()`` dict; every piece starts at a multiple
# of four floats. 1265 floats in all.
PACKED_LAYOUT = (
    ("conv1", 0, (3, 3, 1, 8)),
    ("b1", 72, (8,)),
    ("conv2", 80, (3, 3, 8, 16)),
    ("b2", 1232, (16,)),
    ("fc", 1248, (16,)),
    ("fc_b", 1264, (1,)),
)

_WIN = 12


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


def unpack_cnn_weights(packed_w: torch.Tensor) -> list:
    """The packed [1265] buffer → views (conv1, b1, conv2, b2, fc, fc_b)."""
    return [packed_w[off:off + int(torch.Size(shape).numel())].view(shape)
            for _, off, shape in PACKED_LAYOUT]


def score_frame_window_plain(norm: torch.Tensor, packed_w: torch.Tensor, scale: int,
                             y: int, x: int) -> torch.Tensor:
    """The head count's CNN task body: the 12×12 window at (y, x) of the
    normalized frame (int32 holding uint16) decimated by ``scale``, scaled to
    [0, 1] and scored → 0-dim float32."""
    f = norm.to(torch.float32) / 65535.0
    win = f[::scale, ::scale][y : y + _WIN, x : x + _WIN]
    return conv_window_scores_plain(win[None].contiguous(), *unpack_cnn_weights(packed_w))[0]
