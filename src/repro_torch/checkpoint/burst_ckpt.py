"""Burst-checkpointed training state (``repro/checkpoint/burst_ckpt.py``;
the paper's Algorithm 1 applied to training).

The training loop executes in *bursts* of k steps. After each burst the full
state (parameters, optimizer) is written to a new checkpoint and the
**burst index is committed atomically last** (write-temp → fsync → rename),
the NVM protocol of the paper's runtime. A crash at any point loses at most
one uncommitted burst; on restart the loop resumes from the last committed
index and the deterministic data pipeline regenerates the same batches.
The state is pickled as a tree of numpy arrays (tensors are copied to the
host first), so a checkpoint reads back on any device.

``plan_burst_schedule`` chooses the checkpoint cadence with the Julienning
optimizer itself: tasks = steps, E_s = restart cost, E_w = state-write time,
Q_max = the maximum tolerated work-loss per failure (seconds), solved on the
port's façade: by default with the numpy oracle DP, as ``repro`` solves it;
``backend="cuda"`` runs the same solve on the sweep kernel.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..api import PartitionSpec, solve
from ..core.cost import CostModel, LinearTransfer
from ..core.graph import GraphBuilder
from ..core.partition import Partition

__all__ = ["BurstCheckpointer", "plan_burst_schedule"]


def _to_host(tree):
    """A tree of dicts, lists and tuples with tensor leaves → the same tree
    of numpy arrays (other leaves through ``np.asarray``)."""
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class BurstCheckpointer:
    """Atomic, resumable checkpoint directory."""

    def __init__(self, path: str, keep: int = 2):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)

    def _index_file(self) -> str:
        return os.path.join(self.path, "burst_index")

    def committed_burst(self) -> int:
        f = self._index_file()
        if not os.path.exists(f):
            return 0
        with open(f) as fh:
            return int(fh.read().strip())

    def save(self, burst: int, state: Dict[str, Any]) -> int:
        """Write checkpoint ``burst``, then commit the index atomically.
        Returns the checkpoint's bytes."""
        ck = os.path.join(self.path, f"ckpt_{burst:08d}.pkl")
        fd, tmp = tempfile.mkstemp(dir=self.path)
        host_state = _to_host(state)
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(host_state, fh, protocol=pickle.HIGHEST_PROTOCOL)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, ck)
        # linearization point: everything before this is invisible on crash
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "w") as fh:
            fh.write(str(burst))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._index_file())
        self._gc(burst)
        return os.path.getsize(ck)

    def restore(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        b = self.committed_burst()
        if b == 0:
            return None
        ck = os.path.join(self.path, f"ckpt_{b:08d}.pkl")
        with open(ck, "rb") as fh:
            return b, pickle.load(fh)

    def _gc(self, newest: int) -> None:
        for f in sorted(os.listdir(self.path)):
            if f.startswith("ckpt_"):
                idx = int(f.split("_")[1].split(".")[0])
                if idx <= newest - self.keep:
                    os.remove(os.path.join(self.path, f))


def plan_burst_schedule(
    n_steps: int,
    step_seconds: float,
    state_bytes: int,
    max_loss_seconds: float,
    restart_seconds: float = 30.0,
    disk_bw: float = 1e9,
    backend: str = "numpy",
) -> Partition:
    """Julienne the training run into checkpoint bursts.

    Returns the partition of steps into bursts minimizing total time
    (steps + checkpoint writes + per-burst restart exposure) such that no
    burst's work exceeds ``max_loss_seconds`` (the failure-loss budget).
    ``backend`` is any of the façade's (``numpy``, ``torch``, ``cuda``, ...).
    """
    b = GraphBuilder()
    prev = None
    for i in range(n_steps):
        pkt = b.packet(f"state{i}", state_bytes, keep=(i == n_steps - 1))
        reads = (prev,) if prev else ()
        b.task(f"step{i}", reads=reads, writes=(pkt,), cost=step_seconds)
        prev = pkt
    graph = b.build()
    cm = CostModel(
        e_startup=restart_seconds,
        read=LinearTransfer(c0=1.0, c1=1.0 / disk_bw),
        write=LinearTransfer(c0=1.0, c1=1.0 / disk_bw),
        name="ckpt-disk",
    )
    return solve(PartitionSpec(
        graph=graph, cost=cm, q_max=max_loss_seconds, backend=backend,
    )).partition()
