"""Swarm placement CLI: partition one model across N harvesting nodes.

The port's copy of ``repro/launch/swarm.py``. Loads either an NS Optimizer
profile pair (``--prof prof.csv --dep dep.csv`` — see
:mod:`repro_torch.data.ns_optimizer`) or a zoo config (``--arch qwen3-4b
--buckets 2x16``), then solves the bandwidth × memory × Q placement grid in
**one** batched ``Engine.solve`` call — on the card by default (the torch
grid solver, ``scan``; the per-node budget's Q_min on the sweep kernel), or
with ``--device cpu`` on the host (``scan-cpu``, the plain sweep) — and
reports:

* the bandwidth sweep — per-link total energy, nodes used, transfer
  overhead and hop latency;
* the best cell's per-node split — span, burst count, span energy, peak
  NVM footprint, hop TX/RX and the node's total spent draw;
* conservation — every feasible plan's per-node
  :class:`~repro_torch.obs.ledger.EnergyLedger` must conserve node-by-node and
  sum back to the plan total (nonzero exit on imbalance).

Telemetry mirrors the other launch CLIs: ``--trace-out`` writes a
Perfetto-loadable trace with one track per node (``PID_SWARM`` /
:func:`~repro_torch.obs.trace.node_tid`), ``--metrics-out`` snapshots the
metrics registry, ``--ledger-out`` dumps the best plan's merged per-node
ledger rows, and ``--table-out`` persists the whole sweep as a versioned
:class:`~repro_torch.core.placement.PlacementTable` JSON.

Example::

    python -m repro_torch.launch.swarm --prof prof.csv --dep dep.csv \\
        --nodes 3 --bandwidths 900:3400:100 --table-out swarm.json
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

from ..obs.ledger import EnergyLedger, LedgerImbalance
from ..obs.metrics import METRICS
from ..obs.trace import PID_SWARM, TRACER, node_tid

__all__ = ["build_swarm_spec", "load_graph", "report_sweep", "main"]


def load_graph(args) -> Tuple[object, object, str]:
    """Resolve the (graph, cost model, label) triple from the CLI mode."""
    from ..core.layer_profile import default_cost_model

    kind = args.kind or "time"
    cm = default_cost_model(kind)
    if args.prof or args.dep:
        if not (args.prof and args.dep):
            raise SystemExit("--prof and --dep go together (NS Optimizer mode)")
        if args.arch:
            raise SystemExit("--prof/--dep and --arch are exclusive modes")
        from ..data.ns_optimizer import load_ns_model

        model = load_ns_model(args.prof, args.dep)
        return model.graph, cm, model.summary()
    from .planner import _parse_buckets, lower_buckets, resolve_config

    cfg = resolve_config(args.arch, not args.full)
    bucket = _parse_buckets(args.buckets)[0]
    graph = lower_buckets(cfg, [bucket], kind)[0]
    label = (
        f"{args.arch} bucket {bucket[0]}x{bucket[1]}: "
        f"{graph.n_tasks} tasks, {len(graph.packets)} packets"
    )
    return graph, cm, label


def build_swarm_spec(graph, cm, args):
    """The :class:`~repro_torch.core.placement.PlacementSpec` the CLI solves.

    ``--node-q`` defaults to the graph's §4.4 storage minimum Q_min × 1.25
    (matching ``dse --placement``; on the sweep kernel's minimax mode, or
    its plain version with ``--device cpu``); ``--compute-scales`` makes the
    relay chain heterogeneous (one multiplier per node's task costs).
    """
    from ..api import Engine, PartitionSpec
    from ..core.placement import LinkModel, NodeSpec, PlacementSpec
    from .dse import placement_backends

    node_q = args.node_q
    if node_q is None:
        qmin_backend, _ = placement_backends(args.backend, args.device)
        qmin = Engine().solve(
            PartitionSpec(graph=graph, cost=cm, objective="minimax",
                          backend=qmin_backend)
        ).q_min()
        node_q = qmin * 1.25
    scales = _parse_floats(args.compute_scales) if args.compute_scales else []
    if scales and len(scales) != args.nodes:
        raise SystemExit(
            f"--compute-scales needs one value per node "
            f"({args.nodes}), got {len(scales)}"
        )
    from .dse import parse_bandwidths

    nodes = tuple(
        NodeSpec(
            q_max=float(node_q),
            memory_bytes=args.node_memory,
            compute_scale=scales[k] if scales else 1.0,
            name=f"node{k}",
        )
        for k in range(args.nodes)
    )
    return (
        PlacementSpec(
            nodes=nodes,
            links=tuple(
                LinkModel(bandwidth_mbps=float(b))
                for b in parse_bandwidths(args.bandwidths)
            ),
            q_scales=tuple(_parse_floats(args.q_scales)),
            memory_scales=tuple(_parse_floats(args.memory_scales)),
        ),
        float(node_q),
    )


def _parse_floats(text: str) -> List[float]:
    return [float(p) for p in text.split(",") if p.strip()]


def _best_cell(sweep) -> Optional[Tuple[int, int, int]]:
    """First-min grid cell by total energy (C-order ties — deterministic)."""
    import numpy as np

    flat = sweep.e_total.reshape(-1)
    if not np.isfinite(flat).any():
        return None
    idx = int(np.argmin(flat))  # first minimum in C-order
    L, M, Z = sweep.grid_shape
    return idx // (M * Z), (idx // Z) % M, idx % Z


def report_sweep(sweep, *, out=print) -> int:
    """Print the bandwidth sweep at the base (memory, Q) scales; returns
    the number of feasible links."""
    L, _, _ = sweep.grid_shape
    feasible = 0
    for li in range(L):
        link = sweep.inputs.spec.links[li]
        if not sweep.feasible(li, 0, 0):
            out(f"  {link.bandwidth_mbps:8g} mbps  infeasible")
            continue
        feasible += 1
        p = sweep.plan(li, 0, 0)
        out(
            f"  {link.bandwidth_mbps:8g} mbps  E={p.e_total:.6g}  "
            f"nodes={p.n_nodes_used}  bursts={p.n_bursts}  "
            f"transfer={100 * p.transfer_overhead:5.2f}%  "
            f"hops={len(p.hop_boundaries)} "
            f"({p.transfer_bytes:.3g} B, {p.total_hop_latency_s:.3g} s)"
        )
    return feasible


def _emit_node_tracks(plan) -> None:
    """One Perfetto track per node: a span carrying the node's split, an
    instant per hop on the sending node's track, and a node-energy counter."""
    if not TRACER.enabled:
        return
    TRACER.set_process(PID_SWARM, "swarm")
    for k, ((i, j), bursts) in enumerate(zip(plan.spans, plan.node_bursts)):
        tid = node_tid(k)
        TRACER.set_thread(PID_SWARM, tid, f"node{k}")
        with TRACER.span(
            f"span<{i},{j}>", cat="swarm", pid=PID_SWARM, tid=tid,
            bursts=len(bursts),
            energy=plan.node_energy[k],
            spent=plan.node_spent(k),
            memory_bytes=plan.node_memory_bytes[k],
        ):
            pass
        if k < len(plan.hop_boundaries):
            TRACER.instant(
                f"hop b={plan.hop_boundaries[k]}", cat="swarm",
                pid=PID_SWARM, tid=tid,
                nbytes=plan.hop_bytes[k],
                tx=plan.hop_tx[k], rx=plan.hop_rx[k],
                latency_s=plan.hop_latency_s[k],
            )
        TRACER.counter(
            "node_energy", {f"node{k}": plan.node_spent(k)},
            pid=PID_SWARM, tid=tid,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prof", default=None,
                    help="NS Optimizer prof.csv (layer, time, output mb, "
                    "memory mb)")
    ap.add_argument("--dep", default=None,
                    help="NS Optimizer dep.csv (Source,Destination edges)")
    ap.add_argument("--arch", default=None,
                    help="zoo config name instead of --prof/--dep")
    ap.add_argument("--buckets", default="2x16",
                    help="BATCHxSEQ bucket for --arch (first one is used)")
    ap.add_argument("--full", action="store_true",
                    help="full config instead of the smoke config (--arch)")
    ap.add_argument("--kind", choices=("time", "memory"), default=None,
                    help="cost interpretation (default time)")
    ap.add_argument("--nodes", type=int, default=3,
                    help="relay-chain length (default 3)")
    ap.add_argument("--bandwidths", default="900:3400:100",
                    help="link sweep: start:stop[:step] mbps (stop "
                    "exclusive) or a comma list (default 900:3400:100)")
    ap.add_argument("--node-q", type=float, default=None,
                    help="per-node burst budget (default: Q_min × 1.25)")
    ap.add_argument("--node-memory", type=float, default=None,
                    help="per-node NVM bytes (default unbounded)")
    ap.add_argument("--q-scales", default="1.0",
                    help="comma-separated node-budget multipliers (Q axis)")
    ap.add_argument("--memory-scales", default="1.0",
                    help="comma-separated node-memory multipliers")
    ap.add_argument("--compute-scales", default="",
                    help="comma-separated per-node task-cost multipliers "
                    "(heterogeneous chain; one per node)")
    ap.add_argument("--backend", default="auto",
                    help="solver backend (auto → the torch grid solver: scan "
                    "on the card, scan-cpu with --device cpu)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda: solve on the card; cpu: the plain versions "
                    "on the host")
    ap.add_argument("--table-out", default=None,
                    help="write the sweep as PlacementTable JSON")
    ap.add_argument("--ledger-out", default=None,
                    help="dump the best plan's merged per-node ledger JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON with one track "
                    "per node")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot as JSON")
    args = ap.parse_args(argv)
    if not (args.prof or args.dep or args.arch):
        ap.error("pick a mode: --prof/--dep (NS Optimizer) or --arch (zoo)")
    if args.trace_out:
        TRACER.configure(enabled=True)

    from ..api import Engine, PartitionSpec
    from .dse import placement_backends

    graph, cm, label = load_graph(args)
    print(f"[swarm] loaded {label}")
    spec, node_q = build_swarm_spec(graph, cm, args)
    backend = placement_backends(args.backend, args.device)[1]
    L, M, Z = spec.grid_shape
    t0 = time.time()
    with TRACER.span("swarm.solve", cat="swarm", pid=PID_SWARM, tid=0,
                     links=L, mem=M, q=Z, nodes=spec.n_nodes):
        sol = Engine().solve(
            PartitionSpec(
                graph=graph, cost=cm, placement=spec, backend=backend
            )
        )
    sweep = sol.placement_sweep()
    dt = time.time() - t0
    print(
        f"[swarm] solved {spec.n_nodes} nodes × {L} links × {M} mem × {Z} Q "
        f"grid on backend {sol.backend} in {dt:.2f}s "
        f"(node_q={node_q:.4g})"
    )
    print("[swarm] bandwidth sweep (base memory/Q scales):")
    feasible = report_sweep(sweep)
    best = _best_cell(sweep)
    if best is None:
        print("[swarm] no feasible placement anywhere on the grid — raise "
              "--node-q/--node-memory or add nodes", file=sys.stderr)
        return 2

    li, m, z = best
    plan = sweep.plan(li, m, z)
    print(
        f"[swarm] best cell: link={plan.link.bandwidth_mbps:g} mbps "
        f"memory×{plan.memory_scale:g} q×{plan.q_scale:g} — {plan.summary()}"
    )
    print("[swarm] per-node split:")
    for k, ((i, j), bursts) in enumerate(zip(plan.spans, plan.node_bursts)):
        tx = plan.hop_tx[k] if k < len(plan.hop_tx) else 0.0
        rx = plan.hop_rx[k - 1] if k >= 1 else 0.0
        print(
            f"  node{k}  span<{i},{j}>  bursts={len(bursts)}  "
            f"E={plan.node_energy[k]:.6g}  "
            f"mem={plan.node_memory_bytes[k]:.3g} B  "
            f"tx={tx:.3g}  rx={rx:.3g}  spent={plan.node_spent(k):.6g}"
        )
    print(
        f"[swarm] transfer overhead {100 * plan.transfer_overhead:.2f}% "
        f"({plan.transfer_energy:.6g} of E_total {plan.e_total:.6g}; "
        f"{plan.transfer_bytes:.3g} B, {plan.total_hop_latency_s:.3g} s "
        f"hop latency)"
    )
    _emit_node_tracks(plan)

    # Conservation gate: every feasible cell's plan must be structurally
    # sound and conserve energy node-by-node.
    checked = 0
    try:
        for p in sweep.plans():
            if p is None:
                continue
            p.validate()
            p.check_conservation()
            checked += 1
    except (AssertionError, LedgerImbalance) as exc:
        print(f"[swarm] CONSERVATION FAILURE: {exc}", file=sys.stderr)
        return 1
    print(
        f"[swarm] ledger: {checked} feasible plans conserve node-by-node "
        f"(per-node ledgers sum to each plan total)"
    )

    if args.table_out:
        from ..core.placement import PlacementTable

        meta = {
            "tool": "swarm",
            "nodes": spec.n_nodes,
            "node_q": node_q,
            "kind": args.kind or "time",
            "backend": sol.backend,
        }
        if args.arch:
            meta["arch"] = args.arch
        if args.prof:
            meta["prof"] = args.prof
            meta["dep"] = args.dep
        table = PlacementTable(sweep, meta=meta)
        table.to_json(args.table_out)
        print(f"[swarm] wrote {table.summary()} → {args.table_out}")
    if args.ledger_out:
        merged = EnergyLedger()
        for led in plan.ledgers():
            merged.entries.extend(led.entries)
        merged.dump_json(
            args.ledger_out, tool="swarm", nodes=plan.n_nodes_used,
            link_mbps=plan.link.bandwidth_mbps, e_total=plan.e_total,
        )
        print(f"[swarm] wrote {len(merged.entries)} ledger rows "
              f"→ {args.ledger_out}")
    if args.trace_out:
        n_ev = TRACER.write(args.trace_out)
        print(f"[swarm] wrote {n_ev} trace events to {args.trace_out}")
    if args.metrics_out:
        METRICS.dump_json(args.metrics_out, tool="swarm")
        print(f"[swarm] wrote metrics snapshot to {args.metrics_out}")
    return 0 if feasible else 2


if __name__ == "__main__":
    sys.exit(main())
