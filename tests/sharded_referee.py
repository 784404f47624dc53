"""``repro``'s per-device numbers on a (2, 4) ("data", "model") mesh of eight
forced host devices, for ``tests/test_torch_sharding.py``.

Run as a script in a process of its own: ``XLA_FLAGS`` must force the
eight host devices before jax is imported, which the test process has
already done with one. Prints one JSON object: for each "arch/kind" cell at
B × S, the per-device FLOPs of ``analyze_hlo`` over the compiled step's HLO
and its collectives by kind (count and bytes).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/sharded_referee.py tinyllama-1.1b/train xlstm-1.3b/decode ...
"""

import json
import os
import sys

if "--xla_force_host_platform_device_count=8" not in os.environ.get("XLA_FLAGS", ""):
    raise SystemExit("set XLA_FLAGS=--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import SMOKE_CONFIGS  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.roofline import analyze_hlo  # noqa: E402
from repro.launch.steps import build_cell  # noqa: E402

B, S = 8, 32


def main(cells):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    out = {}
    for cell_name in cells:
        arch, kind = cell_name.split("/")
        cell = build_cell(SMOKE_CONFIGS[arch], ShapeConfig("t", S, B, kind), mesh)
        stats = analyze_hlo(cell.lower().compile().as_text())
        out[cell_name] = {"flops": int(stats.flops),
                          "coll_count_by_kind": dict(stats.coll_count_by_kind),
                          "coll_bytes_by_kind": dict(stats.coll_bytes_by_kind)}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
