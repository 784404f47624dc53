"""ctypes launcher of the CUDA sweep kernel (``csrc/partition_sweep.cu``).

Replaces ``repro/kernels/partition_sweep/kernel.py::_sweep_kernel``. The
wrapper checks dtypes, devices and contiguity, sizes the kernel's cluster
layout (:func:`sweep_layout`: which CTA owns which i, and whether the dp
slices live in shared or device memory), allocates the outputs and any
device-memory scratch with ``torch.empty``, launches on the current stream
and raises on any launch or cluster-launch error.
``sweep_columns_cuda.launches`` counts launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .._build import check, load_library, smem_optin

__all__ = ["sweep_columns_cuda", "sweep_layout", "sweep_smem_bytes", "SweepLayout",
           "CLUSTER", "MAX_CLUSTER", "MAX_SLICE", "lane_warps"]

# Must agree with csrc/partition_sweep.cu (kThreads, kPer, kMaxCluster, kMaxG,
# kSlots, kColWin, kSlotWin); the wrapper holds the two byte counts against
# each other.
THREADS = 1024
WARPS = THREADS // 32
MAX_SLICE = 4 * THREADS     # column elements a CTA holds: 4 an owner thread
CLUSTER = 8                 # CTAs in the cluster: the portable size
MAX_CLUSTER = 16            # with the non-portable attribute, where one warp walks each lane
MAX_LANE_WARPS = 4         # most warps that share one lane's i-range
SLOTS = 3                  # columns of pushed entries in flight
COL_WINDOW = 256
SLOT_WINDOW = 256
_STAGE_BYTES = (2 * COL_WINDOW * 8 * 2 + 2 * SLOT_WINDOW * 8 * 2
                + 2 * (COL_WINDOW + 1) * 4 + 2 * SLOT_WINDOW * 4 * 3)


def lane_warps(nq: int) -> int:
    """Warps that share one lane's i-range: each pushes one entry a column."""
    return 1 if nq >= WARPS else min(WARPS // nq, MAX_LANE_WARPS)


def sweep_smem_bytes(slice_: int, nq: int, cluster: int, dp_in_smem: bool) -> int:
    """Dynamic shared memory of one CTA: the staging windows and its column
    slice, plus in the shared layout its dp slice [nq][slice], the last two
    columns' dp [2][nq] and the entries the CTAs push to it,
    [SLOTS][nq][cluster·G] (value, index)."""
    fixed = _STAGE_BYTES + 8 * slice_
    entries = 12 * SLOTS * cluster * nq * lane_warps(nq)
    return fixed + (8 * nq * (slice_ + 2) + entries if dp_in_smem else 0)


@dataclass(frozen=True)
class SweepLayout:
    """How one launch cuts the i-range: CTA r of ``cluster`` owns i in
    [r·slice + 1, min((r+1)·slice, n)]; the dp slices and the pushed
    entries live in shared memory if ``dp_in_smem``, else in device memory,
    ``dp_elems`` doubles and ``entry_elems`` (value, index) pairs."""
    n: int
    nq: int
    cluster: int
    slice: int
    dp_in_smem: bool
    smem_bytes: int

    @property
    def dp_elems(self) -> int:
        return self.cluster * self.nq * (self.slice + 2)

    @property
    def entry_elems(self) -> int:
        return self.cluster * SLOTS * self.nq * self.cluster * lane_warps(self.nq)

    def owned(self) -> List[Tuple[int, int]]:
        """(first i, last i) of each CTA; last < first where a CTA owns none."""
        return [(r * self.slice + 1, min((r + 1) * self.slice, self.n))
                for r in range(self.cluster)]


def sweep_layout(n: int, nq: int, smem_limit: int, cluster: Optional[int] = None
                 ) -> SweepLayout:
    """The layout of one launch over ``n`` tasks and ``nq`` lanes on a card
    whose blocks may opt in to ``smem_limit`` bytes of shared memory: the
    dp slices in shared memory where they fit, else in device memory. The
    cluster holds 8 CTAs, or 16 where one warp walks each lane's i-range
    (17 lanes or more) over a graph of at least 1024 tasks: there each
    column's DP reads every lane's dp row of the slice from shared memory,
    and half the slice halves those reads. Raises where even the device
    layout does not fit."""
    if n < 1 or nq < 1:
        raise ValueError(f"need n >= 1 and nq >= 1, got n={n}, nq={nq}")
    if cluster is None:
        cluster = MAX_CLUSTER if lane_warps(nq) == 1 and n >= MAX_CLUSTER * 64 else CLUSTER
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster of {cluster} CTAs outside 1..{MAX_CLUSTER}")
    slice_ = -(-n // cluster)
    if slice_ > MAX_SLICE:
        raise ValueError(f"{n} tasks need {slice_} column elements a CTA; at most "
                         f"{MAX_SLICE} ({cluster * MAX_SLICE} tasks)")
    for dp_in_smem in (True, False):
        need = sweep_smem_bytes(slice_, nq, cluster, dp_in_smem)
        if need <= smem_limit:
            return SweepLayout(n, nq, cluster, slice_, dp_in_smem, need)
    raise ValueError(f"a slice of {slice_} tasks needs {need} B of shared memory; one "
                     f"block may use at most {smem_limit} B on this card")


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, dev: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def sweep_columns_cuda(
    read_ptr: torch.Tensor,     # (N+1,) i32
    e_task: torch.Tensor,       # (N,)   f64
    store_add: torch.Tensor,    # (N,)   f64
    e_startup: float,
    slot_cost: torch.Tensor,    # (nnz,) f64
    slot_free: torch.Tensor,    # (nnz,) f64
    slot_lt: torch.Tensor,      # (nnz,) i32
    slot_writer: torch.Tensor,  # (nnz,) i32
    slot_linf: torch.Tensor,    # (nnz,) i32
    budget: torch.Tensor,       # (nq,)  f64
    *,
    exact_k: bool,
    combine_max: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mns, bests), each ``(N, nq)``, computed by the CUDA kernel; the
    same contract as :func:`.ref.sweep_columns_plain`."""
    dev = e_task.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_columns_cuda needs CUDA tensors, got {dev}")
    n = int(e_task.shape[0])
    nq = int(budget.shape[0])
    nnz = int(slot_cost.shape[0])
    for name, t, dt, size in (
        ("read_ptr", read_ptr, torch.int32, n + 1),
        ("e_task", e_task, torch.float64, n),
        ("store_add", store_add, torch.float64, n),
        ("slot_cost", slot_cost, torch.float64, nnz),
        ("slot_free", slot_free, torch.float64, nnz),
        ("slot_lt", slot_lt, torch.int32, nnz),
        ("slot_writer", slot_writer, torch.int32, nnz),
        ("slot_linf", slot_linf, torch.int32, nnz),
        ("budget", budget, torch.float64, nq),
    ):
        _expect(t, name, dt, dev)
        if t.dim() != 1 or t.shape[0] != size:
            raise ValueError(f"{name}: expected shape ({size},), got {tuple(t.shape)}")
    if n < 1 or nq < 1:
        raise ValueError(f"need n >= 1 and nq >= 1, got n={n}, nq={nq}")

    lib = load_library()
    with torch.cuda.device(dev):
        lay = sweep_layout(n, nq, smem_optin(torch.cuda.current_device()))
        kernel_bytes = int(lib.partition_sweep_smem_bytes(lay.slice, nq, lay.cluster,
                                                          int(lay.dp_in_smem)))
        if kernel_bytes != lay.smem_bytes:
            raise RuntimeError(f"sweep layout disagrees with the kernel: {lay.smem_bytes} B "
                               f"here, {kernel_bytes} B in partition_sweep.cu")
        mns = torch.empty((n, nq), dtype=torch.float64, device=dev)
        bests = torch.empty((n, nq), dtype=torch.int32, device=dev)
        if lay.dp_in_smem:
            dp = part_v = part_i = None
        else:
            dp = torch.empty(lay.dp_elems, dtype=torch.float64, device=dev)
            part_v = torch.empty(lay.entry_elems, dtype=torch.float64, device=dev)
            part_i = torch.empty(lay.entry_elems, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.partition_sweep_launch(
            read_ptr.data_ptr(), e_task.data_ptr(), store_add.data_ptr(),
            float(e_startup), slot_cost.data_ptr(), slot_free.data_ptr(),
            slot_lt.data_ptr(), slot_writer.data_ptr(), slot_linf.data_ptr(),
            budget.data_ptr(), mns.data_ptr(), bests.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (dp, part_v, part_i)),
            n, nq, int(bool(exact_k)), int(bool(combine_max)), lay.cluster, lay.slice,
            int(lay.dp_in_smem), stream,
        )
        check(lib, rc, "partition_sweep launch")
        sweep_columns_cuda.launches += 1
    return mns, bests


sweep_columns_cuda.launches = 0
