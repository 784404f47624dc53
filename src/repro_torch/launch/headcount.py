"""Partition and run the head-count application on the port.

    python -m repro_torch.launch.headcount [--spec thermal|visual] [--device cuda]

On the unreduced 5458-task graph (``--reduce`` shrinks the CNN task counts
for quick runs): the CSR export; then, through the façade
(:func:`repro_torch.api.solve`: the sweep kernel on the card, its plain
version with ``--device cpu``), Q_min on the kernel's minimax mode, the
9-point Q grid (Q_min, seven geometric points up to 1.05·E_app, unbounded)
on its sum mode, and exact-K at Q_min with K the burst count of the Q_min
partition; the Fig. 6 table (bursts, E_total, overhead, storage
reduction against the whole-application burst); then the Q_min partition
executed under :class:`BurstRuntime` with one injected power failure, its
head count compared with atomic execution. Prints one JSON object per line;
exits 1 if the two head counts differ.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import PartitionSpec, Solution, solve
from ..core.apps.headcount import THERMAL, VISUAL, build_graph, paper_cost_model
from ..core.cost import CostModel
from ..core.graph import TaskGraph
from ..core.partition import Partition, whole_app_partition
from ..core.runtime import BurstRuntime, MemoryNVM, PowerFailure, execute_atomic
from ..device import resolve_device

__all__ = ["run", "solve_partitions", "main", "SEED"]

SPECS = {"thermal": THERMAL, "visual": VISUAL}
SEED = 3  # CNN weights and input frame of examples/headcount_partition.py


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _print_json(record: Dict[str, object]) -> None:
    print(json.dumps(record), flush=True)


def solve_partitions(
    g: TaskGraph, cm: CostModel, dev: torch.device
) -> Tuple[float, List[Optional[float]], Solution, Partition]:
    """The head count's solve through the façade on ``dev``'s backend:
    (Q_min, the 9-point Q grid, its sum solution, the exact-K partition at
    Q_min with K the burst count of the Q_min partition)."""
    backend = "cuda" if dev.type == "cuda" else "torch"
    qmn = solve(PartitionSpec(graph=g, cost=cm, objective="minimax",
                              backend=backend)).q_min()
    e_app = g.total_task_cost()
    qs: List[Optional[float]] = (
        [qmn] + [float(q) for q in np.geomspace(qmn * 1.01, e_app * 1.05, 7)] + [None]
    )
    sol = solve(PartitionSpec(graph=g, cost=cm, q_grid=tuple(qs), backend=backend))
    k = len(sol.sweep.bounds(0))
    part_k = solve(PartitionSpec(graph=g, cost=cm, objective="exact_k", n_bursts=k,
                                 q_max=qmn, backend=backend)).partition()
    return qmn, qs, sol, part_k


def run(spec_name: str = "thermal", device="cuda", reduce: int = 0,
        emit: Callable[[Dict[str, object]], None] = _print_json) -> Dict[str, object]:
    """Solve and execute one head-count application; ``emit`` receives one
    record per phase. Returns the summary with the sweep and partitions."""
    dev = resolve_device(device)
    spec = SPECS[spec_name]
    if reduce:
        spec = spec.reduced(reduce)
    cm = paper_cost_model()
    g = build_graph(spec, with_fns=True, seed=SEED, device=dev)
    csr = g.to_csr_arrays()
    emit({"phase": "export", "spec": spec.name, "tasks": g.n_tasks,
          "read_slots": csr.nnz_reads, "csr_bytes": csr.nbytes})

    t0 = time.perf_counter()
    qmn, qs, sol, part_k = solve_partitions(g, cm, dev)
    solve_s = time.perf_counter() - t0
    res, k = sol.sweep, part_k.n_bursts
    e_app = g.total_task_cost()
    q_whole = whole_app_partition(g, cm).max_burst

    rows = []
    for qi, q in enumerate(qs):
        if not res.feasible[qi]:
            rows.append({"q_max": q, "bursts": None})
            continue
        e_tot = float(res.e_total[qi])
        qv = q_whole if q is None else q
        rows.append({
            "q_max": q, "bursts": len(res.bounds(qi)), "e_total": e_tot,
            "overhead_pct": 100 * (e_tot - e_app) / e_tot,
            "storage_reduction_pct": 100 * (1 - qv / q_whole),
        })
    emit({"phase": "partition", "q_min": qmn, "e_app": e_app, "q_whole": q_whole,
          "solve_s": solve_s, "table": rows,
          "exact_k": {"k": k, "e_total": part_k.e_total, "max_burst": part_k.max_burst}})

    # Execute the Q_min partition with one power failure halfway through.
    part = sol.partition()
    crash_at = part.n_bursts // 2
    fired: List[int] = []

    def crash_once(b: int, phase: str) -> None:
        if b == crash_at and phase == "executed" and not fired:
            fired.append(b)
            raise PowerFailure(f"injected at burst {b}")

    t0 = time.perf_counter()
    ref = execute_atomic(g, {}, device=dev)
    _sync(dev)
    atomic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt = BurstRuntime(g, part, MemoryNVM(), cost=cm, crash_hook=crash_once, device=dev)
    out = rt.run_to_completion({})
    _sync(dev)
    runtime_s = time.perf_counter() - t0
    summary = {
        "phase": "execute", "bursts": part.n_bursts, "power_failures": len(fired),
        "replays": rt.stats.replays, "headcount": int(out["headcount"]),
        "headcount_atomic": int(ref["headcount"]), "atomic_s": atomic_s,
        "runtime_s": runtime_s,
    }
    emit(summary)
    return {"q_min": qmn, "sweep": res, "q_values": qs, "exact_k": part_k,
            "partition": part, **summary}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", choices=sorted(SPECS), default="thermal")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", type=int, default=0,
                    help="keep ~1/REDUCE of the CNN window tasks (0 = full graph)")
    args = ap.parse_args(argv)
    r = run(args.spec, args.device, args.reduce)
    return 0 if r["headcount"] == r["headcount_atomic"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
