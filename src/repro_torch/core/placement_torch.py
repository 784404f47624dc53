"""The placement grid solver in torch float64, on the card or the CPU.

The counterpart of ``repro/core/placement_jax.py`` (its ``lax.scan``
``_placement_kernel``), as a host loop of batched device ops:

* the per-node burst DP (``S[i, b]`` over all span starts at once) is a loop
  over the columns ``b = 1..n``, each column one set of ops over every
  (node, q_scale) lane;
* the chain DP over node count is a loop over ``k = 1..N``, each step one set
  of ops over every (link, memory, q) grid point.

Bit-identity contract: the solver consumes the
:class:`~repro_torch.core.placement.PlacementInputs` arrays the numpy oracle
does — built on the host in numpy, so every product in a budget threshold or
a hop energy is rounded once, there — and on the device performs only the
oracle's additions, comparisons and minima, in its order: the first-min
argmin idiom ``min(where(cand == mn, index, big))`` (never ``argmin``, whose
tie-break CUDA does not promise), the ``(dp + hop) + seg`` accumulation and
``+ 0.0`` for the hopless first node. Column ``b``'s candidates are taken
over the rows ``i ≤ b`` and the starts ``a ≤ b`` that the oracle reads: the
rows below keep their initial values and the starts above would add inf,
which never beats a finite minimum and leaves an all-inf row's first index
at 1 (``inf == inf``), as the reference's full-width masked rows do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .cost import CostModel
from .graph import TaskGraph
from .placement import (
    PLACEMENT_COUNT,
    PlacementInputs,
    PlacementSpec,
    PlacementSweep,
    _finalize,
    placement_inputs,
)

__all__ = ["solve_placement_torch"]


def _first_min(cand: torch.Tensor, index: torch.Tensor, big: int):
    """(min, first index of the min) along the last axis, the oracle's
    idiom: all-inf rows return the first index."""
    mn = cand.min(dim=-1).values
    first = torch.where(cand == mn[..., None], index, big).min(dim=-1).values
    return mn, first


def _lane_energies(inputs: PlacementInputs, dev: torch.device) -> torch.Tensor:
    """Every (node, q_scale) lane's burst energies ``(N·Z, n+2, n+2)`` on
    ``dev``, bursts over the lane's budget threshold at inf."""
    n, N, Z = inputs.n_tasks, inputs.n_nodes, inputs.q_thresh.shape[1]
    energy = torch.as_tensor(inputs.energy).to(dev)
    thresh = torch.as_tensor(inputs.q_thresh).to(dev)
    ec = torch.where(energy[:, None] <= thresh[:, :, None, None], energy[:, None],
                     float("inf"))
    return ec.reshape(N * Z, n + 2, n + 2)


def _inner_dp(ec: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Span-start DP for every lane of ``ec`` ``(K, n+2, n+2)`` (the node's
    burst energies with over-budget bursts at inf): ``S[k, i, b]`` is the
    least energy of tasks ``i..b`` (``S[k, i, i-1] = 0``), ``A`` the start
    of its last burst."""
    K, dev = ec.shape[0], ec.device
    idx = torch.arange(n + 2, device=dev)
    S = torch.full((K, n + 2, n + 2), float("inf"), dtype=torch.float64, device=dev)
    S[:, idx[1:], idx[:-1]] = 0.0
    A = torch.zeros((K, n + 2, n + 2), dtype=torch.int32, device=dev)
    a_arr = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    for b in range(1, n + 1):
        # cand[k, i, a] = S[k, i, a-1] + E_k⟨a,b⟩ for i ≤ b, a = 1..b
        cand = S[:, : b + 1, 0:b] + ec[:, None, 1 : b + 1, b]
        mn, first = _first_min(cand, a_arr[:b], n + 2)
        S[:, : b + 1, b] = mn
        A[:, : b + 1, b] = first
    return S, A


def _outer_dp(S: torch.Tensor, memok: torch.Tensor, hop: torch.Tensor,
              lanes: Tuple[torch.Tensor, ...], n: int, N: int):
    """Chain DP for every (link, memory, q) lane: ``dp[g, k-1, j]`` is the
    least energy of tasks ``1..j`` on exactly the first ``k`` nodes,
    ``parent`` node ``k``'s span start. ``S`` is ``(N, Z, n+2, n+2)``,
    ``memok`` ``(N, M, n+2, n+2)``, ``hop`` ``(L, n+1)``."""
    li, mi, zi = lanes
    G, dev = li.shape[0], S.device
    Z = S.shape[1]
    inf = float("inf")
    i_arr = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    j_arr = torch.arange(n + 1, device=dev)
    upper = i_arr[None, :] <= j_arr[:, None]                      # (n+1, n)
    mz = mi * Z + zi
    dp = torch.empty((G, N, n + 1), dtype=torch.float64, device=dev)
    parent = torch.empty((G, N, n + 1), dtype=torch.int32, device=dev)
    dp_prev = torch.full((G, n + 1), inf, dtype=torch.float64, device=dev)
    dp_prev[:, 0] = 0.0
    hop_lanes = hop[li, 0:n]
    for k in range(1, N + 1):
        # seg[m, z, j, i] = S_k[z, i, j] where node k's memory holds span i..j,
        # inf for i > j: one table per (memory, q) pair, gathered per lane
        seg = torch.where(memok[k - 1][:, None], S[k - 1][None], inf)
        seg = torch.where(upper, seg[:, :, 1 : n + 1, 0 : n + 1].transpose(2, 3), inf)
        # node 1 receives no hop; the accumulation order is ((dp + X) + S)
        base = dp_prev[:, 0:n] + (hop_lanes if k >= 2 else 0.0)
        cand = seg.reshape(-1, n + 1, n).index_select(0, mz)
        cand.add_(base[:, None, :])
        mn, first = _first_min(cand, i_arr, n + 2)
        dp[:, k - 1] = mn
        parent[:, k - 1] = first
        dp_prev = mn
    return dp, parent


def solve_placement_torch(
    graph: TaskGraph,
    cost: CostModel,
    spec: PlacementSpec,
    *,
    inputs: Optional[PlacementInputs] = None,
    device="cuda",
) -> PlacementSweep:
    """Solve the whole placement grid on ``device``, bit-identical to
    :func:`~repro_torch.core.placement.solve_placement_numpy` in all six
    DP arrays. The sweep's backend is ``"scan"`` on the card (the
    reference's name) and ``"scan-cpu"`` on the CPU."""
    dev = resolve_device(device)
    if inputs is None:
        inputs = placement_inputs(graph, cost, spec)
    backend = "scan" if dev.type == "cuda" else "scan-cpu"
    PLACEMENT_COUNT[backend] += 1
    n, N = inputs.n_tasks, inputs.n_nodes
    L, M, Z = inputs.grid_shape

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    S, A = _inner_dp(_lane_energies(inputs, dev), n)
    S = S.reshape(N, Z, n + 2, n + 2)
    memok = up(inputs.mem)[None, None] <= up(inputs.mem_thresh)[:, :, None, None]
    # C-order lane indices over the (link, memory, q) grid
    g = torch.arange(L * M * Z, device=dev)
    lanes = (g // (M * Z), (g // Z) % M, g % Z)
    dp, parent = _outer_dp(S, memok, up(inputs.hop_total), lanes, n, N)
    outer_dp = dp.cpu().numpy().reshape(L, M, Z, N, n + 1)
    e_total, k_used = _finalize(outer_dp, n, N)
    return PlacementSweep(
        inputs=inputs,
        backend=backend,
        e_total=e_total,
        k_used=k_used,
        outer_dp=outer_dp,
        outer_parent=parent.cpu().numpy().reshape(L, M, Z, N, n + 1),
        inner_S=S.cpu().numpy(),
        inner_A=A.reshape(N, Z, n + 2, n + 2).cpu().numpy(),
    )
