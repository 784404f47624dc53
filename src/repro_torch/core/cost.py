"""Cost models for burst execution (paper §4.1).

The port's copy of the transfer/startup model of ``repro/core/cost.py``:
``E(p) = c0 * p.c0_weight + c1 * p.nbytes`` per direction plus a startup
cost ``E_s`` per burst. "Energy" is any additive scalar; the paper's
instance is Joules on the FRAM/LPC54102 prototype.
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
