"""Sharded design-space exploration: Q-sharded plan-table builds.

The port's copy of ``repro/launch/dse.py``. The paper's Julienning flow is an
offline DSE — solve the energy-bounded partition for every (application,
E_burst) point of interest. This module is that flow at bucket-fleet scale:
the Q grid splits into chunks (:func:`repro_torch.core.partition_torch.shard_q_grid`),
each solved on its own card (:func:`repro_torch.launch.mesh.shard_devices`)
or one after another on one, and the gathered per-chunk columns assemble
into one versioned table whose content is byte-identical to a single
:func:`build_plan_table` run.

Growth is incremental: :func:`extend_for_arch` appends new shape buckets (and
optionally new Q points) to an existing table without re-solving any tabulated
cell, and the header's ``lineage`` fingerprint chain records each extension.
On load, :func:`probe_table` re-validates K random cells against the live
engine so a table that outlived an engine or cost-model change fails loudly
(:class:`repro_torch.core.plan_table.StaleTableError`) instead of serving
stale plans.

CLI (``--device cuda``, the default, solves on the card; ``--device cpu`` on
the plain versions on the host)::

    # fresh sharded build
    python -m repro_torch.launch.dse --arch qwen3-4b --buckets 2x24,2x48 \\
        --q-points 16 --shards 2 --out plan_qwen.npz

    # incremental: append a bucket + two Q points, no re-solve of old cells
    python -m repro_torch.launch.dse --arch qwen3-4b --buckets 2x24,2x48,4x48 \\
        --extend --add-q 1.5e-3,2.5e-3 --shards 2 --out plan_qwen.npz

    # load-time staleness probe of an existing table (no rebuild)
    python -m repro_torch.launch.dse --arch qwen3-4b --probe-only --probe 8 \\
        --out plan_qwen.npz

    # close the calibration loop: captured ledger → measured cost table →
    # drift probe of the tabulated plans against the refreshed profile
    python -m repro_torch.launch.dse --arch qwen3-4b --calibrate ledger.json \\
        --out plan_qwen.npz --probe 4

    # swarm placement DSE: sweep link bandwidths × per-node budgets across a
    # relay chain in one batched solve, into a versioned placement table
    python -m repro_torch.launch.dse --arch qwen3-4b --placement --nodes 3 \\
        --bandwidths 900:3400:100 --out placement_qwen.json
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..api import QGridSharding
from ..core.plan_table import (
    PlanTable,
    build_plan_table,
    extend_plan_table,
    probe_plan_table,
)
from ..core.layer_profile import default_cost_model
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from .planner import (
    _BACKEND_OF_DEVICE,
    _parse_buckets,
    derive_q_grid,
    lower_buckets,
    resolve_config,
    shard_devices_for,
)

__all__ = [
    "build_placement_table_for_arch",
    "build_sharded_table_for_arch",
    "calibrate_table",
    "extend_for_arch",
    "parse_bandwidths",
    "probe_table",
]


def build_sharded_table_for_arch(
    arch: str,
    shape_buckets: List[Tuple[int, int]],
    n_q: int = 16,
    *,
    n_shards: int,
    smoke: bool = True,
    kind: str = "time",
    cache_dir: Optional[str] = None,
    backend: str = "auto",
) -> PlanTable:
    """Sharded sibling of :func:`repro_torch.launch.planner.build_table_for_arch`:
    same derived Q grid, same bytes, the solve's Q grid in ``n_shards``
    chunks (one per card, or one after another when the host has fewer)."""
    cfg = resolve_config(arch, smoke)
    cm = default_cost_model(kind)
    graphs = lower_buckets(cfg, shape_buckets, kind)
    qs = derive_q_grid(graphs, cm, n_q, backend=backend)
    return build_plan_table(
        cfg, shape_buckets, qs, kind=kind, cost=cm, backend=backend,
        cache_dir=cache_dir, graphs=graphs,
        sharding=QGridSharding(n_shards, shard_devices_for(backend, n_shards)),
    )


def extend_for_arch(
    base: Union[PlanTable, str],
    arch: str,
    shape_buckets: Sequence[Tuple[int, int]],
    *,
    add_q_values: Sequence[Optional[float]] = (),
    smoke: bool = True,
    n_shards: Optional[int] = None,
    cache_dir: Optional[str] = None,
    backend: str = "auto",
) -> PlanTable:
    """Extend an existing table with whatever of ``shape_buckets`` /
    ``add_q_values`` it does not already tabulate (existing cells are
    byte-moved, never re-solved). ``n_shards`` shards the extension solves."""
    if isinstance(base, str):
        base = PlanTable.load(base)
    cfg = resolve_config(arch, smoke)
    # extend_plan_table itself ignores already-tabulated buckets/Q points,
    # so the full request list passes straight through.
    return extend_plan_table(
        base, cfg, add_buckets=shape_buckets, add_q_values=add_q_values,
        backend=backend, n_shards=n_shards,
        devices=None if n_shards is None else shard_devices_for(backend, n_shards),
        cache_dir=cache_dir,
    )


def probe_table(
    table: Union[PlanTable, str],
    arch: str,
    *,
    k: Optional[int] = 4,
    seed: int = 0,
    smoke: bool = True,
    measured=None,
    drift_tol: float = 0.05,
    backend: str = "auto",
) -> int:
    """Load-time staleness probe by arch name (see
    :func:`repro_torch.core.plan_table.probe_plan_table`). ``measured`` (a
    :class:`repro_torch.core.calibration.MeasuredCostTable`) additionally
    checks probed cells' tabulated draw against the refreshed measured
    profile."""
    if isinstance(table, str):
        table = PlanTable.load(table)
    return probe_plan_table(table, resolve_config(arch, smoke), k=k, seed=seed,
                            measured=measured, drift_tol=drift_tol, backend=backend)


def calibrate_table(
    ledger_json: str,
    *,
    kind: str = "time",
    out_json: Optional[str] = None,
):
    """Rebuild a measured cost table from a captured ledger dump
    (``EnergyLedger.dump_json`` / ``launch/traffic.py --ledger-out``) and
    optionally persist it as versioned calibration JSON."""
    from ..core.calibration import MeasuredCostTable

    measured = MeasuredCostTable.from_ledger_json(ledger_json, kind=kind)
    if out_json:
        measured.to_json(out_json, source=ledger_json)
    return measured


def parse_bandwidths(text: str) -> List[float]:
    """``"900:3400:100"`` (start:stop:step, stop exclusive — the NS
    Optimizer sweep convention) or a comma list ``"900,1800,3400"``."""
    text = text.strip()
    if ":" in text:
        parts = text.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bandwidth range is start:stop[:step], got {text!r}"
            )
        start, stop = float(parts[0]), float(parts[1])
        step = float(parts[2]) if len(parts) == 3 else 100.0
        if step <= 0 or stop <= start:
            raise ValueError(f"empty bandwidth range {text!r}")
        out = []
        v = start
        while v < stop:
            out.append(v)
            v += step
        return out
    vals = [float(p) for p in text.split(",") if p.strip()]
    if not vals:
        raise ValueError(f"no bandwidths in {text!r}")
    return vals


def placement_backends(backend: str, device: str) -> Tuple[str, str]:
    """(the Q_min solve's backend, the placement solve's backend) for
    ``--backend``/``--device``: ``auto`` on the card is the sweep kernel's
    minimax mode and the torch grid solver there; on the CPU their plain
    versions (``torch``, ``scan-cpu``)."""
    if device == "cpu":
        return "torch", ("scan-cpu" if backend == "auto" else backend)
    return "auto", backend


def build_placement_table_for_arch(
    arch: str,
    bucket: Tuple[int, int],
    *,
    n_nodes: int = 3,
    bandwidths_mbps: Sequence[float] = (),
    node_q: Optional[float] = None,
    node_memory: Optional[float] = None,
    q_scales: Sequence[float] = (1.0,),
    memory_scales: Sequence[float] = (1.0,),
    smoke: bool = True,
    kind: str = "time",
    backend: str = "auto",
    device: str = "cuda",
):
    """Solve one arch bucket's placement grid (links × memory × Q) in one
    batched façade call and wrap it as a versioned
    :class:`~repro_torch.core.placement.PlacementTable`.

    ``node_q=None`` derives the per-node burst budget from the graph: the
    §4.4 storage minimum Q_min × 1.25 — enough headroom that a single node
    stays feasible while tight enough that the budget axis bites.
    """
    from ..api import Engine, PartitionSpec
    from ..core.placement import LinkModel, NodeSpec, PlacementSpec, PlacementTable

    qmin_backend, backend = placement_backends(backend, device)
    cfg = resolve_config(arch, smoke)
    cm = default_cost_model(kind)
    graph = lower_buckets(cfg, [tuple(bucket)], kind)[0]
    if node_q is None:
        qmin = Engine().solve(
            PartitionSpec(graph=graph, cost=cm, objective="minimax",
                          backend=qmin_backend)
        ).q_min()
        node_q = qmin * 1.25
    pspec = PlacementSpec(
        nodes=tuple(
            NodeSpec(q_max=float(node_q), memory_bytes=node_memory)
            for _ in range(int(n_nodes))
        ),
        links=tuple(LinkModel(bandwidth_mbps=float(b)) for b in bandwidths_mbps),
        q_scales=tuple(q_scales),
        memory_scales=tuple(memory_scales),
    )
    sol = Engine().solve(
        PartitionSpec(graph=graph, cost=cm, placement=pspec, backend=backend)
    )
    return PlacementTable(
        sol.placement_sweep(),
        meta={
            "arch": arch,
            "bucket": list(bucket),
            "kind": kind,
            "smoke": bool(smoke),
            "backend": sol.backend,
            "node_q": float(node_q),
        },
    )


def _parse_q_list(text: str) -> List[float]:
    return [float(part) for part in text.split(",") if part.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--buckets", default="2x24,2x48",
                    help="comma-separated BATCHxSEQ buckets, e.g. 2x24,4x48")
    ap.add_argument("--q-points", type=int, default=None,
                    help="geometric Q grid size, default 16 (an unbounded "
                    "point is added; fresh builds only)")
    ap.add_argument("--kind", choices=("time", "memory"), default=None,
                    help="cost interpretation, default time (fresh builds "
                    "only — an extension keeps the base table's kind)")
    ap.add_argument("--shards", type=int, default=1,
                    help="Q-grid shards (one per card when the host has "
                    "that many, else one after another on one)")
    ap.add_argument("--extend", action="store_true",
                    help="extend the existing table at --out instead of "
                    "rebuilding (only missing buckets/Q points are solved)")
    ap.add_argument("--add-q", default="",
                    help="comma-separated Q_max values to append (--extend)")
    ap.add_argument("--probe", type=int, default=0,
                    help="after build/load, re-validate this many random "
                    "cells against the live engine")
    ap.add_argument("--probe-only", action="store_true",
                    help="only probe the existing table at --out — no build, "
                    "no extend, nothing written")
    ap.add_argument("--calibrate", default=None, metavar="LEDGER_JSON",
                    help="rebuild a measured cost table from a captured "
                    "energy-ledger dump (traffic --ledger-out / "
                    "EnergyLedger.dump_json), write it as calibration JSON "
                    "(--calibration-out), and probe the table at --out "
                    "against the measured profile — exits nonzero when any "
                    "probed cell's measured draw drifts beyond --drift-tol")
    ap.add_argument("--calibration-out", default=None,
                    help="measured-table JSON path (--calibrate; default "
                    "<out>.calib.json)")
    ap.add_argument("--drift-tol", type=float, default=0.05,
                    help="relative per-cycle drift tolerance for the "
                    "calibration probe (default 0.05)")
    ap.add_argument("--placement", action="store_true",
                    help="swarm placement DSE: solve the bandwidth × memory "
                    "× Q placement grid for the first --buckets shape across "
                    "--nodes relay nodes in one batched call, writing a "
                    "versioned placement table JSON to --out")
    ap.add_argument("--nodes", type=int, default=3,
                    help="relay-chain length for --placement (default 3)")
    ap.add_argument("--bandwidths", default="900:3400:100",
                    help="link sweep for --placement: start:stop[:step] mbps "
                    "(stop exclusive, NS Optimizer convention) or a comma "
                    "list (default 900:3400:100)")
    ap.add_argument("--node-q", type=float, default=None,
                    help="per-node burst budget for --placement (default: "
                    "the graph's Q_min × 1.25)")
    ap.add_argument("--node-memory", type=float, default=None,
                    help="per-node NVM bytes for --placement (default "
                    "unbounded)")
    ap.add_argument("--q-scales", default="1.0",
                    help="comma-separated node-budget multipliers "
                    "(--placement Q axis)")
    ap.add_argument("--memory-scales", default="1.0",
                    help="comma-separated node-memory multipliers "
                    "(--placement memory axis)")
    ap.add_argument("--backend", default="auto",
                    help="solver backend for --placement (auto → the torch "
                    "grid solver: scan on the card, scan-cpu with --device "
                    "cpu)")
    ap.add_argument("--device", choices=sorted(_BACKEND_OF_DEVICE), default="cuda",
                    help="cuda: solve on the card; cpu: the plain versions "
                    "on the host")
    ap.add_argument("--seed", type=int, default=0, help="probe cell RNG seed")
    ap.add_argument("--out", required=True, help="table .npz path")
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of the smoke config")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON (Perfetto-loadable) "
                         "of the build/extend/probe")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot as JSON")
    args = ap.parse_args(argv)
    if args.trace_out:
        TRACER.configure(enabled=True)

    buckets = _parse_buckets(args.buckets)
    smoke = not args.full
    backend = _BACKEND_OF_DEVICE[args.device]
    if args.extend or args.probe_only or args.calibrate:
        # the base table fixes the grid parameters — refuse silent drops
        if args.kind is not None or args.q_points is not None:
            ap.error("--kind/--q-points are fixed by the existing table; "
                     "not valid with --extend/--probe-only/--calibrate")
    if args.calibrate and (args.extend or args.probe_only):
        ap.error("--calibrate is its own mode; drop --extend/--probe-only")
    if args.placement and (args.extend or args.probe_only or args.calibrate):
        ap.error("--placement is its own mode; drop "
                 "--extend/--probe-only/--calibrate")

    def _flush_telemetry() -> None:
        if args.trace_out:
            n_ev = TRACER.write(args.trace_out)
            print(f"[dse] wrote {n_ev} trace events to {args.trace_out}")
        if args.metrics_out:
            METRICS.dump_json(args.metrics_out, tool="dse", arch=args.arch)
            print(f"[dse] wrote metrics snapshot to {args.metrics_out}")

    if args.placement:
        t0 = time.time()
        table = build_placement_table_for_arch(
            args.arch, buckets[0],
            n_nodes=args.nodes,
            bandwidths_mbps=parse_bandwidths(args.bandwidths),
            node_q=args.node_q,
            node_memory=args.node_memory,
            q_scales=_parse_q_list(args.q_scales),
            memory_scales=_parse_q_list(args.memory_scales),
            smoke=smoke, kind=args.kind or "time", backend=args.backend,
            device=args.device,
        )
        table.to_json(args.out)
        dt = time.time() - t0
        print(f"[dse] solved {table.summary()} in {dt:.2f}s → {args.out}")
        L, M, Z = table.grid_shape
        print(f"[dse]   grid: {L} links × {M} memory × {Z} Q "
              f"({args.nodes} nodes, node_q={table.meta['node_q']:.4g})")
        _flush_telemetry()
        return 0
    if args.probe_only:
        n = probe_table(args.out, args.arch, k=args.probe or None,
                        seed=args.seed, smoke=smoke, backend=backend)
        print(f"[dse] probe: {n} cells of {args.out} re-validated against "
              f"the live engine — clean")
        _flush_telemetry()
        return 0
    if args.calibrate:
        from ..core.plan_table import StaleTableError

        table = PlanTable.load(args.out)
        calib_out = args.calibration_out or args.out + ".calib.json"
        measured = calibrate_table(args.calibrate, kind=table.kind,
                                   out_json=calib_out)
        restore = measured.stats["restore"]
        print(f"[dse] calibrated {measured.n_samples} ledger samples from "
              f"{args.calibrate} → {calib_out}")
        print(f"[dse]   restore: n={restore.count} mean={restore.mean:.3e} "
              f"std={restore.std:.3e} (analytical "
              f"e_startup={float(measured.base.e_startup):.3e})")
        print(f"[dse]   fingerprint: {measured.fingerprint()[:16]}")
        try:
            n = probe_table(table, args.arch, k=args.probe or None,
                            seed=args.seed, smoke=smoke, measured=measured,
                            drift_tol=args.drift_tol, backend=backend)
        except StaleTableError as exc:
            print(f"[dse]   STALE: {exc}", file=sys.stderr)
            _flush_telemetry()
            return 1
        print(f"[dse]   probe:   {n} cells of {args.out} within "
              f"{args.drift_tol:.1%} of the measured profile — accepted")
        _flush_telemetry()
        return 0
    t0 = time.time()
    if args.extend:
        table = extend_for_arch(
            args.out, args.arch, buckets,
            add_q_values=_parse_q_list(args.add_q),
            smoke=smoke, n_shards=args.shards, backend=backend,
        )
        verb = "extended"
    else:
        if args.add_q:
            ap.error("--add-q only makes sense with --extend")
        table = build_sharded_table_for_arch(
            args.arch, buckets, args.q_points or 16,
            n_shards=args.shards, smoke=smoke, kind=args.kind or "time",
            backend=backend,
        )
        verb = "built"
    table.save(args.out)
    dt = time.time() - t0
    n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    print(f"[dse] {verb} {table.summary()} in {dt:.2f}s "
          f"({args.shards} shards, {n_dev} {args.device} devices) "
          f"→ {args.out}")
    print(f"[dse]   lineage: {' → '.join(f[:12] for f in table.lineage)}")
    print(f"[dse]   digest:  {table.content_digest()[:16]}")
    if args.probe:
        n = probe_table(args.out, args.arch, k=args.probe, seed=args.seed,
                        smoke=smoke, backend=backend)
        print(f"[dse]   probe:   {n} cells re-validated against the live "
              f"engine — clean")
    _flush_telemetry()
    return 0


if __name__ == "__main__":
    sys.exit(main())
