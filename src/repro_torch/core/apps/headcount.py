"""The paper's head-counting applications (§5–§6) as task graphs.

The port of ``repro/core/apps/headcount.py``: the same 5458-task sequence
(sense → normalize → initialize → CNN1 ×4125 → CNN2 ×936 → CNN3 ×391 →
sort → nms → transmit), the same packets and costs — so the CSR export is
equal array for array — and the same seeded CNN weights.

With ``with_fns=True`` every task carries a body whose packets are tensors
on ``device``: ``normalize`` and each ``cnn*`` body run there (a CNN body is
one :func:`repro_torch.kernels.conv_window.ops.score_frame_window` call:
on a card one kernel launch that reads its window straight from the
normalized frame, with the weights packed and the window's offsets computed
once when the graph is built);
``sort``, ``nms`` and ``transmit`` are host numpy, line for line as in the
reference, with ``sort`` fed by one device→host copy of the stacked scores.
The frame and its normalized form live as int32 holding the reference's
uint16 values (torch's uint16 arithmetic is thin).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.conv_window.ops import pack_cnn_weights, score_frame_window, window_offsets
from ..cost import PAPER_FRAM_MODEL, CostModel
from ..graph import GraphBuilder, TaskGraph

__all__ = [
    "HeadCountSpec",
    "THERMAL",
    "VISUAL",
    "build_graph",
    "paper_cost_model",
    "cnn_weights",
    "weights_to_torch",
]


@dataclasses.dataclass(frozen=True)
class HeadCountSpec:
    """Energy/structure parameters (paper Tables 1–2; Joules)."""

    name: str
    e_sense: float                   # image acquisition kernel
    e_transmit: float = 0.086e-3     # BLE transmission
    e_normalize: float = 0.043e-3
    e_initialize: float = 0.003e-3
    e_cnn: Tuple[float, float, float] = (0.396e-3, 0.396e-3, 0.403e-3)
    n_cnn: Tuple[int, int, int] = (4125, 936, 391)
    e_sort: float = 0.010e-3
    e_nms: float = 0.006e-3
    img_bytes: int = 9600            # 80×60 uint16 (Lepton frame)
    norm_bytes: int = 9600
    ws_bytes: int = 64
    score_bytes: int = 4             # float32 per window task
    top_bytes: int = 128
    out_bytes: int = 4

    def reduced(self, scale: int = 64) -> "HeadCountSpec":
        """Same graph shape with ~1/scale of the CNN window tasks (tests)."""
        n = tuple(max(2, c // scale) for c in self.n_cnn)
        return dataclasses.replace(self, name=f"{self.name}-reduced", n_cnn=n)


THERMAL = HeadCountSpec(name="thermal", e_sense=131.9e-3)
VISUAL = HeadCountSpec(name="visual", e_sense=4.4e-3)


def paper_cost_model() -> CostModel:
    return PAPER_FRAM_MODEL


_IMG_H, _IMG_W = 60, 80
_WIN = 12            # window side
_SCALES = (1, 2, 3)  # pyramid decimation per CNN type


def cnn_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic CNN parameters (the same RandomState draws as the
    reference): conv1 3×3×1×8 → relu → 2×2 pool → conv2 3×3×8×16 → relu →
    global mean → fc 16→1, HWIO."""
    r = np.random.RandomState(seed)
    return {
        "conv1": (r.randn(3, 3, 1, 8) * 0.3).astype(np.float32),
        "b1": np.zeros(8, np.float32),
        "conv2": (r.randn(3, 3, 8, 16) * 0.2).astype(np.float32),
        "b2": np.zeros(16, np.float32),
        "fc": (r.randn(16) * 0.5).astype(np.float32),
        "fc_b": np.zeros((), np.float32),
    }


def weights_to_torch(weights: Mapping[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """The CNN weights dict as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {
        k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(dev).contiguous()
        for k, v in weights.items()
    }


def normalize(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalize a frame to the uint16 range (held as int32);
    ``torch.round`` rounds half to even like ``jnp.round``."""
    f = img.to(torch.float32)
    lo, hi = f.min(), f.max()
    n = (f - lo) / torch.clamp(hi - lo, min=1.0)
    return torch.round(n * 65535.0).to(torch.int32)


def score_window(norm: torch.Tensor, weights: Mapping[str, torch.Tensor],
                 scale: int, y: int, x: int) -> torch.Tensor:
    """Score the 12×12 window at (y, x) of the frame decimated by ``scale``
    → 0-dim float32 on the frame's device."""
    return score_frame_window(norm, pack_cnn_weights(weights, norm.device), scale, y, x)


def _window_coords(spec: HeadCountSpec, scale_idx: int) -> List[Tuple[int, int]]:
    """Deterministic window rasterization giving exactly n_cnn[scale_idx]
    windows at pyramid scale ``_SCALES[scale_idx]`` (stride chosen to fit)."""
    n_want = spec.n_cnn[scale_idx]
    s = _SCALES[scale_idx]
    h, w = _IMG_H // s, _IMG_W // s
    coords: List[Tuple[int, int]] = []
    ys = max(h - _WIN, 1)
    xs = max(w - _WIN, 1)
    i = 0
    while len(coords) < n_want:
        y = (i // xs) % ys
        x = i % xs
        coords.append((y, x))
        i += 1
    return coords


def build_graph(
    spec: HeadCountSpec,
    with_fns: bool = False,
    seed: int = 0,
    image: Optional[np.ndarray] = None,
    device="cuda",
) -> TaskGraph:
    """Build the head-counting application as a TaskGraph.

    With ``with_fns=True`` every task carries a runnable body on ``device``
    and the graph can be executed by :class:`repro_torch.core.runtime.BurstRuntime`;
    ``image`` then provides the sensor frame "acquired" by the sense task.
    """
    b = GraphBuilder()
    b.packet("img", spec.img_bytes)
    b.packet("norm", spec.norm_bytes)
    b.packet("ws", spec.ws_bytes)
    n1, n2, n3 = spec.n_cnn
    s1 = b.packet_array("scores1", n1, spec.score_bytes)
    s2 = b.packet_array("scores2", n2, spec.score_bytes)
    s3 = b.packet_array("scores3", n3, spec.score_bytes)
    b.packet("top", spec.top_bytes)
    b.packet("headcount", spec.out_bytes, keep=True)

    fns: Dict[str, object] = {}
    if with_fns:
        dev = resolve_device(device)
        packed = pack_cnn_weights(cnn_weights(seed), dev)
        frame = (
            image
            if image is not None
            else np.random.RandomState(seed).randint(
                0, 65535, size=(_IMG_H, _IMG_W), dtype=np.uint16
            )
        )
        frame_t = torch.as_tensor(np.asarray(frame).astype(np.int32)).to(dev)
        coords = [_window_coords(spec, s) for s in range(3)]
        all_names = s1 + s2 + s3
        all_coords = (
            [(0, yx) for yx in coords[0]]
            + [(1, yx) for yx in coords[1]]
            + [(2, yx) for yx in coords[2]]
        )

        def sense(inp):
            return {"img": frame_t.clone()}

        def normalize_fn(inp):
            return {"norm": normalize(inp["img"])}

        def initialize(inp):
            ws = np.zeros(spec.ws_bytes // 4, np.float32)
            # Detection threshold below the score range (the weights are a
            # seeded stand-in for the paper's trained model), so the count
            # follows score order + NMS geometry and any packet corruption
            # shows; then the NMS suppression radius.
            ws[0] = -1e30
            ws[1] = float(_WIN)
            return {"ws": torch.from_numpy(ws).to(dev)}

        def mk_cnn(scale_idx, t, out_name):
            y, x = coords[scale_idx][t]
            scale = _SCALES[scale_idx]
            offsets = window_offsets(scale, y, x, (_IMG_H, _IMG_W))

            def fn(inp):
                return {out_name: score_frame_window(inp["norm"], packed, scale, y, x, offsets)}

            return fn

        def sort(inp):
            vals = torch.stack([inp[n] for n in all_names]).cpu().numpy()
            order = np.argsort(-vals)[: spec.top_bytes // 8]
            top = np.zeros((len(order), 2), np.float32)
            for r, idx in enumerate(order):
                top[r, 0] = vals[idx]
                top[r, 1] = idx
            return {"top": torch.from_numpy(top).to(dev)}

        def nms(inp):
            top = inp["top"].cpu().numpy()
            ws = inp["ws"].cpu().numpy()
            thresh, radius = float(ws[0]), float(ws[1])
            kept: List[Tuple[int, float, float]] = []
            count = 0
            for row in top:
                score, idx = float(row[0]), int(row[1])
                if score <= thresh:
                    continue
                sc, (y, x) = all_coords[idx]
                s = _SCALES[sc]
                cy, cx = (y + _WIN / 2) * s, (x + _WIN / 2) * s
                if any(
                    abs(cy - ky) < radius and abs(cx - kx) < radius
                    for (_, ky, kx) in kept
                ):
                    continue
                kept.append((sc, cy, cx))
                count += 1
            return {"headcount": torch.tensor(count, dtype=torch.int32, device=dev)}

        def transmit(inp):
            return {}  # BLE send: consumes headcount, produces nothing

        fns.update(sense=sense, normalize=normalize_fn, initialize=initialize,
                   sort=sort, nms=nms, transmit=transmit)
        for sc in range(3):
            for t in range(spec.n_cnn[sc]):
                out = (s1, s2, s3)[sc][t]
                fns[f"cnn{sc + 1}_{t}"] = mk_cnn(sc, t, out)

    def fn_of(name):
        return fns.get(name) if with_fns else None

    b.task("sense", reads=(), writes=("img",), cost=spec.e_sense, fn=fn_of("sense"))
    b.task("normalize", reads=("img",), writes=("norm",), cost=spec.e_normalize,
           fn=fn_of("normalize"))
    b.task("initialize", reads=(), writes=("ws",), cost=spec.e_initialize,
           fn=fn_of("initialize"))
    for sc, (names, e) in enumerate(zip((s1, s2, s3), spec.e_cnn)):
        for t, out in enumerate(names):
            b.task(
                f"cnn{sc + 1}_{t}", reads=("norm",), writes=(out,), cost=e,
                fn=fn_of(f"cnn{sc + 1}_{t}"),
            )
    b.task("sort", reads=tuple(s1 + s2 + s3), writes=("top",), cost=spec.e_sort,
           fn=fn_of("sort"))
    b.task("nms", reads=("top", "ws"), writes=("headcount",), cost=spec.e_nms,
           fn=fn_of("nms"))
    b.task("transmit", reads=("headcount",), writes=(), cost=spec.e_transmit,
           fn=fn_of("transmit"))
    return b.build()
