"""``repro``'s per-device numbers on meshes of eight forced host devices,
for ``tests/test_torch_sharding.py``.

Run as a script in a process of its own: ``XLA_FLAGS`` must force the
eight host devices before jax is imported, which the test process has
already done with one. Takes one JSON list of cells, each ``{"name",
"arch", "kind", "b", "s", "mesh": [sizes], "replace": {field: value}}``
and optionally ``"names"``, the mesh's axis names (default ``["data",
"model"]``); ``replace`` is applied to the smoke config by
``dataclasses.replace`` (a key ``"moe.<field>"`` replaces a field of the
MoE config), and the mesh's devices are the first host devices. Prints one JSON object: for each cell's name, the per-device
FLOPs of ``analyze_hlo`` over the compiled step's HLO and its collectives
by kind (count and bytes).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python tests/sharded_referee.py \\
        '[{"name": "x", "arch": "xlstm-1.3b", "kind": "decode", "b": 2, "s": 32,
           "mesh": [2, 4], "replace": {}}]'
"""

import dataclasses
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


def replaced(cfg, fields):
    """``cfg`` with ``fields`` replaced; ``"moe.<field>"`` names a field of
    ``cfg.moe``."""
    top = {k: v for k, v in fields.items() if "." not in k}
    moe = {k.split(".", 1)[1]: v for k, v in fields.items() if k.startswith("moe.")}
    if moe:
        top["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **top)


def main(cells):
    out = {}
    for c in cells:
        shape = tuple(c["mesh"])
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                    tuple(c.get("names", ("data", "model"))))
        cfg = replaced(SMOKE_CONFIGS[c["arch"]], c.get("replace", {}))
        cell = build_cell(cfg, ShapeConfig("t", c["s"], c["b"], c["kind"]), mesh)
        stats = analyze_hlo(cell.lower().compile().as_text())
        out[c["name"]] = {"flops": int(stats.flops),
                          "coll_count_by_kind": dict(stats.coll_count_by_kind),
                          "coll_bytes_by_kind": dict(stats.coll_bytes_by_kind)}
    print(json.dumps(out))


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
