"""Per-device FLOPs on a (2, 2, 2) ("pod", "data", "model") mesh, the port
against ``repro``, for the recurrent families at B 4 × S 32 (smoke
configs), where the batch leaves "pod" free. Not a test: it prints the
figures that ROADMAP queue 3 gives for the open "pod" piece of F1.

    PYTHONPATH=src python tests/sharded_pod_probe.py

For each (arch, step kind): each package's per-device FLOPs and their
ratio to 1/8 of its own one-device count (``repro``'s from
``tests/sharded_referee.py`` in a subprocess with eight forced host
devices, the port's from ``build_cell(...).count()`` on a ``fake`` mesh).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import build_cell

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("pod", "data", "model")
MESH, B, S = (2, 2, 2), 4, 32
CELLS = [(a, k) for a in ("xlstm-1.3b", "zamba2-7b") for k in ("train", "prefill", "decode")]


def main():
    cells = []
    for a, k in CELLS:
        base = {"arch": a, "kind": k, "b": B, "s": S, "replace": {}}
        cells.append(dict(base, name=f"{a}/{k}", mesh=list(MESH), names=list(NAMES)))
        cells.append(dict(base, name=f"{a}/{k}/one", mesh=[1], names=["data"]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "sharded_referee.py"),
                          json.dumps(cells)], env=env, capture_output=True, text=True,
                         check=True).stdout
    ref = json.loads(out.strip().splitlines()[-1])
    n = 1
    for m in MESH:
        n *= m
    for a, k in CELLS:
        shape = ShapeConfig(f"s_{k}", S, B, k)
        _, st = build_cell(SMOKE_CONFIGS[a], shape, "meta",
                           mesh=mesh_mod.count_mesh(MESH, NAMES)).count()
        _, one = build_cell(SMOKE_CONFIGS[a], shape, "meta").count()
        r, r1 = ref[f"{a}/{k}"]["flops"], ref[f"{a}/{k}/one"]["flops"]
        print(json.dumps({"arch": a, "kind": k, "port_flops": st.flops,
                          "port_x_n_over_one": st.flops * n / one.flops,
                          "repro_flops": r, "repro_x_n_over_one": r * n / r1}))


if __name__ == "__main__":
    main()
