"""Plain PyTorch version of the CSR sweep kernel, and the host slot pricing.

:func:`slot_costs` and :func:`store_add_ref` price the export on the host in
numpy float64, in the reference's exact rounding sequence, so no product is
ever re-rounded on the device; the kernel and this plain version take the
same priced tensors.

:func:`sweep_columns_plain` replays ``_iter_columns`` of
``repro/kernels/partition_sweep/ref.py`` — extension, loads, freed stores,
diagonal, slot by slot — on float64 tensors of whatever device they lie on,
then one of the three DP combines vectorized over the lane axis with a
first-minimum argmin. Every operation is an IEEE add, subtract, compare or
max, so its tables are bitwise equal to the numpy oracles and to the kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...core.cost import CostModel, cost_scalars
from ...core.graph import GraphCSRArrays

__all__ = ["slot_costs", "store_add_ref", "sweep_columns_plain"]


def slot_costs(
    csr: GraphCSRArrays, cost: CostModel
) -> Tuple[np.ndarray, np.ndarray]:
    """Per read slot: (E_r of the packet, E_w of the packet). ``E_w`` of a
    *read* packet is the store charged back when one burst absorbs both the
    writer and the last reader."""
    _, r_c0, r_c1, w_c0, w_c1 = cost_scalars(cost)
    slot_cost = r_c0 * csr.read_c0w + r_c1 * csr.read_bytes
    slot_free = w_c0 * csr.read_c0w + w_c1 * csr.read_bytes
    return slot_cost, slot_free


def store_add_ref(csr: GraphCSRArrays, cost: CostModel) -> np.ndarray:
    """S(j) = Σ_{p ∈ writes(j), l_∞(p) > j} E_w(p), in write-slot order."""
    _, _, _, w_c0, w_c1 = cost_scalars(cost)
    n = csr.n_pad
    out = np.zeros(n, dtype=np.float64)
    ptr = csr.write_ptr
    for j in range(1, n + 1):
        s = 0.0
        for k in range(int(ptr[j - 1]), int(ptr[j])):
            if int(csr.write_linf[k]) > j:
                s += w_c0 * float(csr.write_c0w[k]) + w_c1 * float(csr.write_bytes[k])
        out[j - 1] = s
    return out


def sweep_columns_plain(
    read_ptr: torch.Tensor,     # (N+1,) i32
    e_task: torch.Tensor,       # (N,)   f64
    store_add: torch.Tensor,    # (N,)   f64
    e_startup: float,
    slot_cost: torch.Tensor,    # (nnz,) f64
    slot_free: torch.Tensor,    # (nnz,) f64
    slot_lt: torch.Tensor,      # (nnz,) i32
    slot_writer: torch.Tensor,  # (nnz,) i32
    slot_linf: torch.Tensor,    # (nnz,) i32
    budget: torch.Tensor,       # (nq,)  f64, tolerance-scaled
    *,
    exact_k: bool,
    combine_max: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mns, bests), each ``(N, nq)``, on the inputs' device.

    ``mns[j-1, q]`` is dp[q, j], ``bests[j-1, q]`` the smallest start of a
    last burst achieving it. With ``exact_k`` the lanes are burst counts
    b = 0..K and lane b combines against dp[b-1] (lane 0 against +inf, so
    its argmin degenerates to 1). ``combine_max`` selects ``max`` over ``+``.
    """
    dev = e_task.device
    n = int(e_task.shape[0])
    nq = int(budget.shape[0])
    inf = float("inf")
    # Loop bounds and per-task scalars drive Python control flow: read them
    # once on the host (exact copies; no value is re-rounded).
    ptr = read_ptr.tolist()
    lts, wrs, lis = slot_lt.tolist(), slot_writer.tolist(), slot_linf.tolist()
    ers, frs = slot_cost.tolist(), slot_free.tolist()
    ejs, sjs = e_task.tolist(), store_add.tolist()
    e_s = float(e_startup)

    col = torch.full((n + 2,), float("nan"), dtype=torch.float64, device=dev)
    dp = torch.full((nq, n + 1), inf, dtype=torch.float64, device=dev)
    if exact_k:
        dp[0, 0] = 0.0
    else:
        dp[:, 0] = 0.0
    mns = torch.empty((n, nq), dtype=torch.float64, device=dev)
    bests = torch.empty((n, nq), dtype=torch.int32, device=dev)
    ar = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    big = torch.tensor(n + 1, dtype=torch.int64, device=dev)
    bud = budget.to(torch.float64)[:, None]
    inf_row = torch.full((1, n), inf, dtype=torch.float64, device=dev)

    for j in range(1, n + 1):
        e_j, s_j = ejs[j - 1], sjs[j - 1]
        if j > 1:
            col[1:j] += e_j + s_j
        sum_er = 0.0
        for k in range(ptr[j - 1], ptr[j]):
            er = ers[k]
            sum_er += er
            lt = lts[k]
            if j > 1 and lt + 1 < j:
                col[lt + 1 : j] += er
            if j > 1 and lis[k] == j and wrs[k] >= 1:
                col[1 : wrs[k] + 1] -= frs[k]
        col[j] = e_s + sum_er + e_j + s_j

        c = col[1 : j + 1][None, :]
        masked = torch.where(c <= bud, c, inf)
        prev = dp[:, :j]
        if exact_k:
            prev = torch.cat([inf_row[:, :j], prev[:-1]], dim=0)
        cand = torch.maximum(prev, masked) if combine_max else prev + masked
        m = cand.min(dim=1).values
        first = torch.where(cand == m[:, None], ar[:j], big).min(dim=1).values
        dp[:, j] = m
        mns[j - 1] = m
        bests[j - 1] = first.to(torch.int32)
    return mns, bests
