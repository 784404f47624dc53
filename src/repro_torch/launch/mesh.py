"""The devices of the offline DSE's Q-grid shards.

The port's counterpart of ``repro/launch/mesh.py``, which builds JAX device
meshes: the production TPU meshes (``make_production_mesh``, a 16 × 16 or
2 × 16 × 16 ("pod", "data", "model") layout), a one-device host mesh, and
the one-axis ("shard",) mesh of the DSE sweep. Only the last has a
counterpart on CUDA cards: the Q grid's chunks are plain torch devices, one
per chunk (:class:`~repro_torch.core.engine.QGridSharding`). The TPU mesh
layouts have none — one card has no data or model axis to lay out — so
they are not ported.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["shard_devices"]


def shard_devices(n_shards: int) -> Optional[List[torch.device]]:
    """The first ``n_shards`` CUDA devices in shard order, or None when the
    host has fewer (callers then run the same chunks one after another on
    one device)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]
