"""ctypes launcher of the CUDA sweep kernel (``csrc/partition_sweep.cu``).

Replaces ``repro/kernels/partition_sweep/kernel.py::_sweep_kernel``. The
wrapper checks dtypes, devices and contiguity, allocates the outputs and the
dp scratch with ``torch.empty``, refuses a column that does not fit in one
block's shared memory (it never tiles silently), launches on the current
stream and raises on any launch error. ``sweep_columns_cuda.launches``
counts launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import check, load_library, smem_optin

__all__ = ["sweep_columns_cuda"]

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
        limit = smem_optin(torch.cuda.current_device())
        need = int(lib.partition_sweep_smem_bytes(n, nq))
        if need > limit:
            raise ValueError(
                f"live column of {n} tasks needs {need} B of shared memory; "
                f"one block may use at most {limit} B on this card"
            )
        mns = torch.empty((n, nq), dtype=torch.float64, device=dev)
        bests = torch.empty((n, nq), dtype=torch.int32, device=dev)
        dp = torch.empty((nq, n + 1), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.partition_sweep_launch(
            read_ptr.data_ptr(), e_task.data_ptr(), store_add.data_ptr(),
            float(e_startup), slot_cost.data_ptr(), slot_free.data_ptr(),
            slot_lt.data_ptr(), slot_writer.data_ptr(), slot_linf.data_ptr(),
            budget.data_ptr(), mns.data_ptr(), bests.data_ptr(), dp.data_ptr(),
            n, nq, int(bool(exact_k)), int(bool(combine_max)), stream,
        )
        check(lib, rc, "partition_sweep launch")
        sweep_columns_cuda.launches += 1
    return mns, bests


sweep_columns_cuda.launches = 0
