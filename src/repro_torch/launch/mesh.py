"""Device meshes (``repro/launch/mesh.py``).

* :func:`make_production_mesh` — ``repro``'s production layouts: one pod,
  256 devices as ("data", "model") = (16, 16); two pods, 512 as ("pod",
  "data", "model") = (2, 16, 16), the "pod" axis pure data parallelism.
  Over the processes of the default group (``torchrun``'s), which must
  number exactly 256 or 512, as ``jax.make_mesh`` fails on any other count.
* :func:`make_host_mesh` — (1, n) ("data", "model") over the n visible
  cards (or the CPU processes of a gloo group), as ``repro``'s is over the
  host's devices: the mesh ``chip_smoke.py`` and the sharded tests run.
* :func:`count_mesh` — any (shape, names) mesh on the ``fake`` backend, for
  counting a sharded step on ``meta`` (``launch/dryrun.py --multi-pod``):
  no devices, no collectives run, one process stands in for all of them.
  The mesh is typed "cuda" whatever the host has, so DTensor lowers each
  layout change as it would on cards (an all-to-all where a CPU mesh would
  gather), and nothing touches a card.
* :func:`shard_devices` — the DSE's Q-grid chunks, one CUDA device each
  (``repro``'s ("shard",) mesh, :class:`~repro_torch.core.engine.QGridSharding`).

A process has one default process group. The real meshes need it started
beforehand (:func:`init_local_group`: from a ``FileStore`` or ``HashStore``
on this host, never an address); :func:`count_mesh` starts (or restarts) a
``fake`` one of the size it needs, so a process that counts starts no
other group. ``torch.distributed`` and the ``fake`` backend are imported
inside the functions that need them.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import torch

__all__ = ["make_production_mesh", "make_host_mesh", "count_mesh", "production_shape",
           "init_local_group", "shard_devices", "torchrun_rank"]


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of ``repro``'s production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the default group's processes, one card each
    (``device_type`` "cpu": gloo processes), which must be exactly as many
    as its devices (else ``ValueError`` naming the count)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh needs {need} "
                         f"processes, this launch has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(device: str = "cuda"):
    """(1, n) ("data", "model") over the default group's n processes (one
    per card with ``device="cuda"``), ``repro``'s host mesh; one process
    gives (1, 1). Starts a one-process group when none is running."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized():
        init_local_group(0, 1, "nccl" if dev.type == "cuda" else "gloo")
    n = dist.get_world_size()
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (1, n), mesh_dim_names=("data", "model"))


def init_local_group(rank: int, world_size: int, backend: str, path: Optional[str] = None):
    """Start the default process group from a store on this host: a
    ``FileStore`` at ``path`` (shared by the processes of one launch), or a
    ``HashStore`` for a single process. Never an address."""
    import torch.distributed as dist

    if path is None:
        if world_size != 1:
            raise ValueError("processes of one launch share a FileStore: pass its path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


_COUNT_MESHES: dict = {}


def count_mesh(shape: Sequence[int], names: Sequence[str], world: int = 0):
    """A ``shape`` mesh with axes ``names`` over the first ranks of a
    ``fake`` process group (this process rank 0), for counting on ``meta``.
    The group has ``world`` ranks, or the mesh's if more; one of another
    kind, or too small, is replaced. Meshes are kept per (shape, names), so
    a process counting on several meshes starts one group and one set of
    subgroups for each."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(int(s) for s in shape)
    if not (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() >= n):
        if dist.is_initialized():
            dist.destroy_process_group()
        _COUNT_MESHES.clear()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=max(n, world))
    key = (tuple(int(s) for s in shape), tuple(names))
    if key not in _COUNT_MESHES:
        _COUNT_MESHES[key] = DeviceMesh("cuda", torch.arange(n).view(*key[0]),
                                        mesh_dim_names=key[1])
    return _COUNT_MESHES[key]


def shard_devices(n_shards: int) -> Optional[List[torch.device]]:
    """The first ``n_shards`` CUDA devices in shard order, or None when the
    host has fewer (callers then run the same chunks one after another on
    one device)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]


def torchrun_rank() -> Optional[tuple]:
    """(rank, world size) from ``torchrun``'s environment, or None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None
