"""Host wrapper of the sweep: CSR export + cost model in, numpy tables out.

The counterpart of ``repro/kernels/partition_sweep/ops.py::sweep_columns``:
slots are priced on the host (:mod:`.ref`), budget lanes are mapped per mode
in numpy float64 — ``q·(1+REL)+ABS`` per Q for ``"sum"``, one ``+inf`` lane
for ``"minimax"``, K+1 lanes of the single scaled Q_max for ``"exact_k"`` —
and the priced export is uploaded once per (export, cost model, device).

Dispatch is on the device alone: on a CUDA device the kernel runs (or the
call raises); on the CPU the plain version runs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...core._cache import weak_id_cache
from ...core.cost import CostModel
from ...core.graph import GraphCSRArrays
from ...core.partition import BUDGET_ABS as _ABS, BUDGET_REL as _REL
from ...device import resolve_device
from .kernel import sweep_columns_cuda
from .ref import slot_costs, store_add_ref, sweep_columns_plain

__all__ = ["sweep_columns", "budget_lanes", "device_slots"]

# (id(csr), cost, device) -> priced + uploaded slot tensors (core/_cache.py).
_DEVICE_CACHE: dict = {}


def device_slots(csr: GraphCSRArrays, cost: CostModel, device: torch.device) -> tuple:
    """The kernel's first nine operands for ``csr`` under ``cost`` on
    ``device``: (read_ptr, e_task, store_add, e_startup, slot_cost,
    slot_free, slot_lt, slot_writer, slot_linf)."""

    def upload():
        slot_cost, slot_free = slot_costs(csr, cost)
        store_add = store_add_ref(csr, cost)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

        return (
            t(csr.read_ptr, torch.int32),
            t(csr.e_task, torch.float64),
            t(store_add, torch.float64),
            float(cost.e_startup),
            t(slot_cost, torch.float64),
            t(slot_free, torch.float64),
            t(csr.read_lt, torch.int32),
            t(csr.read_writer, torch.int32),
            t(csr.read_linf, torch.int32),
        )

    return weak_id_cache(_DEVICE_CACHE, csr, (cost, str(device)), upload)


def budget_lanes(
    q_values: Sequence[Optional[float]],
    objective: str,
    n_bursts: Optional[int],
    k_objective: str,
) -> Tuple[np.ndarray, bool, bool]:
    """(budget lanes, exact_k, combine_max) for one kernel mode."""
    if objective == "sum":
        qs = np.array(
            [np.inf if q is None else float(q) for q in q_values], dtype=np.float64
        )
        if qs.shape[0] == 0:
            raise ValueError("objective='sum' needs at least one Q value")
        return qs * (1.0 + _REL) + _ABS, False, False
    if objective == "minimax":
        if len(tuple(q_values)) != 0:
            raise ValueError("objective='minimax' takes no Q grid")
        return np.array([np.inf], dtype=np.float64), False, True
    if objective == "exact_k":
        qv = tuple(q_values)
        if len(qv) != 1:
            raise ValueError("objective='exact_k' takes exactly one Q_max")
        if n_bursts is None or int(n_bursts) < 1:
            raise ValueError("objective='exact_k' needs n_bursts >= 1")
        if k_objective not in ("sum", "max"):
            raise ValueError(f"unknown k_objective {k_objective!r}")
        q = np.inf if qv[0] is None else float(qv[0])
        budget = np.full(int(n_bursts) + 1, q * (1.0 + _REL) + _ABS, dtype=np.float64)
        return budget, True, k_objective == "max"
    raise ValueError(f"unknown kernel objective {objective!r}")


def sweep_columns(
    csr: GraphCSRArrays,
    cost: CostModel,
    q_values: Sequence[Optional[float]],
    *,
    objective: str = "sum",
    n_bursts: Optional[int] = None,
    k_objective: str = "sum",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve one CSR export in one kernel mode: → numpy (mns, bests).

    ``"sum"``: tables ``(N, nq)`` over the Q grid. ``"minimax"`` (pass
    ``q_values=()``): ``(N, 1)``, Q_min is ``mns[n_tasks-1, 0]``.
    ``"exact_k"``: one Q_max (``None`` = unbounded) and ``n_bursts=K``;
    tables ``(N, K+1)`` whose lane b is dp[b, j]. Infeasible entries carry
    ``inf`` in mns; bests are meaningful only where mns is finite.
    """
    dev = resolve_device(device)
    budget, exact_k, combine_max = budget_lanes(q_values, objective, n_bursts, k_objective)
    args = device_slots(csr, cost, dev)
    b = torch.as_tensor(budget, dtype=torch.float64).to(dev)
    run = sweep_columns_cuda if dev.type == "cuda" else sweep_columns_plain
    mns, bests = run(*args, b, exact_k=exact_k, combine_max=combine_max)
    return mns.cpu().numpy(), bests.cpu().numpy()
