"""Cost models for burst execution (paper §4.1).

The port's copy of the transfer/startup model of ``repro/core/cost.py``:
``E(p) = c0 * p.c0_weight + c1 * p.nbytes`` per direction plus a startup
cost ``E_s`` per burst. "Energy" is any additive scalar; the paper's
instance is Joules on the FRAM/LPC54102 prototype, the H100's instance
seconds (time-as-energy: volatile = HBM, NVM = pinned host memory over
PCIe; pipeline stages on H100 cards joined by NVLink), priced with the
H100's own constants below.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .graph import Packet

__all__ = [
    "LinearTransfer",
    "CostModel",
    "cost_scalars",
    "cost_from_scalars",
    "PAPER_FRAM_MODEL",
    "PEAK_FLOPS",
    "HBM_BW",
    "PCIE_BW",
    "DMA_INIT_S",
    "LAUNCH_S",
    "NVLINK_BW",
    "HOP_INIT_S",
    "h100_host_offload_model",
    "h100_pipeline_model",
]


@dataclasses.dataclass(frozen=True)
class LinearTransfer:
    """E(p) = c0 * weight(p) + c1 * nbytes(p)."""

    c0: float  # fixed initiation cost (per DMA batch; amortized via c0_weight)
    c1: float  # per-byte cost

    def __call__(self, p: Packet) -> float:
        return self.c0 * p.c0_weight + self.c1 * p.nbytes

    def bytes_cost(self, nbytes: int, c0_weight: float = 1.0) -> float:
        return self.c0 * c0_weight + self.c1 * nbytes


@dataclasses.dataclass(frozen=True)
class CostModel:
    """E_s + E_r(p)/E_w(p) per paper §4.1."""

    e_startup: float
    read: LinearTransfer
    write: LinearTransfer
    name: str = "cost-model"

    def e_r(self, p: Packet) -> float:
        return self.read(p)

    def e_w(self, p: Packet) -> float:
        return self.write(p)


def cost_scalars(cost: CostModel) -> np.ndarray:
    """(E_s, read c0, read c1, write c0, write c1) as a float64 vector."""
    return np.array(
        [cost.e_startup, cost.read.c0, cost.read.c1, cost.write.c0, cost.write.c1],
        dtype=np.float64,
    )


def cost_from_scalars(v: Sequence[float], name: str = "cost-model") -> CostModel:
    """Inverse of :func:`cost_scalars` — how a cost model crosses from
    another implementation as plain data."""
    e_s, r0, r1, w0, w1 = (float(x) for x in v)
    return CostModel(e_s, LinearTransfer(r0, r1), LinearTransfer(w0, w1), name)


# Paper-faithful instance (§6.2): LPC54102 + external Cypress FRAM, Joules.
PAPER_FRAM_MODEL = CostModel(
    e_startup=9e-6,                            # E_s = 9 µJ measured boot cost
    read=LinearTransfer(c0=1.3e-6, c1=7.6e-9),  # E_r(p) = 1.3 µJ + |p| · 7.6 nJ/B
    write=LinearTransfer(c0=0.9e-6, c1=6.2e-9),  # E_w(p) = 0.9 µJ + |p| · 6.2 nJ/B
    name="paper-fram",
)


# H100 instance. Units: seconds. PEAK_FLOPS and HBM_BW are NVIDIA's H100
# SXM data sheet figures at its 700 W limit (bf16 dense on the tensor cores;
# HBM3). PCIE_BW, DMA_INIT_S and LAUNCH_S were measured on an NVIDIA H100
# 80GB HBM3 at 700.00 W by chip_smoke.py's cost_constants phase (median of
# three rounds): pinned 64 MB copies read 47.5-50.0 GB/s host→device and
# 54.8-55.0 device→host (the slower direction is kept); a pinned 4 KB copy
# plus synchronize 10.6-15.0 µs; an empty launch plus synchronize 8.6-12.5
# µs.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
PCIE_BW = 48.8e9
DMA_INIT_S = 14.6e-6
LAUNCH_S = 12.3e-6  # per-segment dispatch: one launch and its synchronize


def h100_host_offload_model(
    pcie_bw: float = PCIE_BW,
    dma_init_s: float = DMA_INIT_S,
    launch_s: float = LAUNCH_S,
) -> CostModel:
    """Activation offload on one H100: volatile = HBM, NVM = pinned host
    memory over PCIe."""
    return CostModel(
        e_startup=launch_s,
        read=LinearTransfer(c0=dma_init_s, c1=1.0 / pcie_bw),
        write=LinearTransfer(c0=dma_init_s, c1=1.0 / pcie_bw),
        name="h100-host-offload",
    )


# Pipeline stages, one H100 SXM card each, joined by NVLink 4: the
# counterpart of repro/core/cost.py::tpu_pipeline_model, whose hops cross
# ICI (one card has none). NVLINK_BW is NVIDIA's H100 SXM data sheet figure:
# 900 GB/s of NVLink bandwidth per card in total, 450 GB/s each way; a hop
# moves the boundary activation one way. HOP_INIT_S, a hop's start-up, is
# LAUNCH_S above (one launch and its synchronize, measured on one card);
# no card-to-card copy has been measured for it.
NVLINK_BW = 450e9
HOP_INIT_S = LAUNCH_S


def h100_pipeline_model(nvlink_bw: float = NVLINK_BW,
                        hop_init_s: float = HOP_INIT_S) -> CostModel:
    """Pipeline-stage partitioning: a burst = a stage; crossing a boundary
    sends the live set over NVLink to the next stage's card, charged once,
    on the read side."""
    return CostModel(
        e_startup=0.0,
        read=LinearTransfer(c0=hop_init_s, c1=1.0 / nvlink_bw),
        write=LinearTransfer(c0=0.0, c1=0.0),
        name="h100-pipeline",
    )
