"""NS Optimizer profile ingestion: ``prof.csv`` / ``dep.csv`` → TaskGraph.

The port's copy of ``repro/data/ns_optimizer.py``. The NS Optimizer
describes a network as two CSVs:

* ``prof.csv`` — one row per layer, measured on a particular device:
  ``Layer name, time (s), output size (mb), memory (mb), MACs`` (the MACs
  column is legacy, always zero; headers optional).
* ``dep.csv`` — ``Source, Destination`` edges between layer names.

:func:`load_ns_model` turns that into the repo's native shapes: a
:class:`~repro_torch.core.graph.TaskGraph` whose tasks are the layers in a
*deterministic* topological order (Kahn's algorithm, ties broken by
``prof.csv`` row order — re-loading the same files always yields the same
task sequence, which the placement/burst DPs depend on), each layer writing
one output packet sized from the ``output size`` column (mb × 10⁶ bytes) and
reading its dependencies' outputs; sink outputs are ``keep`` packets. Layer
times load as task costs (the ``kind="time"`` convention: seconds as the
energy proxy) and double as calibration rows
(:meth:`NSModel.calibration_rows` feeds
``MeasuredCostTable.ingest_rows``), so one profile drives both the solver
and the measured cost path.

Malformed inputs raise the typed :class:`NSOptimizerError`: missing/short
columns, non-numeric fields, duplicate layers, edges naming unknown layers,
self-edges, and dependency cycles (reported with the offending layer set).

Stdlib-only (csv + the core graph builder).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Mapping, Tuple

from ..core.graph import GraphBuilder, TaskGraph

__all__ = ["NSOptimizerError", "NSLayer", "NSModel", "load_ns_model"]

#: bytes per "mb" in NS Optimizer profiles (decimal megabytes)
MB = 1_000_000


class NSOptimizerError(ValueError):
    """Malformed NS Optimizer ``prof.csv`` / ``dep.csv`` inputs."""


@dataclasses.dataclass(frozen=True)
class NSLayer:
    """One ``prof.csv`` row."""

    name: str
    time_s: float
    output_mb: float
    memory_mb: float
    macs: float = 0.0

    @property
    def output_bytes(self) -> int:
        return int(round(self.output_mb * MB))

    @property
    def memory_bytes(self) -> int:
        return int(round(self.memory_mb * MB))


@dataclasses.dataclass(frozen=True, eq=False)
class NSModel:
    """A loaded NS Optimizer profile: the graph plus the raw layer rows
    (in the deterministic topological order the graph's tasks follow)."""

    graph: TaskGraph
    layers: Tuple[NSLayer, ...]
    edges: Tuple[Tuple[str, str], ...]

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_time_s(self) -> float:
        return sum(l.time_s for l in self.layers)

    def calibration_rows(self) -> List[Dict[str, object]]:
        """Layer timings as ``MeasuredCostTable.ingest_rows`` rows — one
        ``compute`` sample per layer (seconds, the ``kind="time"`` energy
        proxy), tagged with the layer name for provenance."""
        return [
            {"category": "compute", "energy": l.time_s, "kernel": l.name}
            for l in self.layers
        ]

    def summary(self) -> str:
        out_mb = sum(l.output_mb for l in self.layers)
        return (
            f"NSModel: {self.n_layers} layers, {len(self.edges)} edges, "
            f"{self.total_time_s:.4g} s total, {out_mb:.4g} mb activations"
        )


def _parse_prof(path: str) -> List[NSLayer]:
    layers: List[NSLayer] = []
    seen: Dict[str, int] = {}
    with open(path, newline="") as f:
        for lineno, row in enumerate(csv.reader(f), start=1):
            cells = [c.strip() for c in row]
            if not any(cells):
                continue
            if lineno == 1 and cells and not _is_float(cells[1] if len(cells) > 1 else ""):
                continue  # header row ("Layer name, time, ...")
            if len(cells) < 4:
                raise NSOptimizerError(
                    f"{path}:{lineno}: prof.csv rows need at least 4 columns "
                    f"(layer, time, output mb, memory mb), got {len(cells)}: "
                    f"{row!r}"
                )
            name = cells[0]
            if not name:
                raise NSOptimizerError(f"{path}:{lineno}: empty layer name")
            if name in seen:
                raise NSOptimizerError(
                    f"{path}:{lineno}: duplicate layer {name!r} "
                    f"(first at row {seen[name]})"
                )
            seen[name] = lineno
            try:
                time_s = float(cells[1])
                output_mb = float(cells[2])
                memory_mb = float(cells[3])
                macs = float(cells[4]) if len(cells) > 4 and cells[4] else 0.0
            except ValueError as exc:
                raise NSOptimizerError(
                    f"{path}:{lineno}: non-numeric profile field in {row!r}"
                ) from exc
            if time_s < 0 or output_mb < 0 or memory_mb < 0:
                raise NSOptimizerError(
                    f"{path}:{lineno}: negative profile value in {row!r}"
                )
            layers.append(NSLayer(name, time_s, output_mb, memory_mb, macs))
    if not layers:
        raise NSOptimizerError(f"{path}: no layers (empty prof.csv)")
    return layers


def _parse_dep(path: str, known: Mapping[str, int]) -> List[Tuple[str, str]]:
    edges: List[Tuple[str, str]] = []
    seen = set()
    with open(path, newline="") as f:
        for lineno, row in enumerate(csv.reader(f), start=1):
            cells = [c.strip() for c in row]
            if not any(cells):
                continue
            if lineno == 1 and [c.lower() for c in cells[:2]] == ["source", "destination"]:
                continue
            if len(cells) < 2 or not cells[0] or not cells[1]:
                raise NSOptimizerError(
                    f"{path}:{lineno}: dep.csv rows are 'Source,Destination' "
                    f"pairs, got {row!r}"
                )
            src, dst = cells[0], cells[1]
            for name in (src, dst):
                if name not in known:
                    raise NSOptimizerError(
                        f"{path}:{lineno}: edge names unknown layer {name!r} "
                        f"(not in prof.csv)"
                    )
            if src == dst:
                raise NSOptimizerError(
                    f"{path}:{lineno}: self-edge on layer {src!r}"
                )
            if (src, dst) not in seen:
                seen.add((src, dst))
                edges.append((src, dst))
    return edges


def _is_float(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return True


def load_ns_model(prof_path: str, dep_path: str) -> NSModel:
    """Load one NS Optimizer testcase (``prof.csv`` + ``dep.csv``).

    See the module docstring for the mapping. Raises
    :class:`NSOptimizerError` on malformed rows, unknown layer references,
    or cyclic dependencies.
    """
    rows = _parse_prof(prof_path)
    order = {l.name: i for i, l in enumerate(rows)}
    edges = _parse_dep(dep_path, order)

    # Deterministic Kahn topological sort: among ready layers, the one
    # earliest in prof.csv runs next (stable across loads and platforms).
    preds: Dict[str, List[str]] = {l.name: [] for l in rows}
    indeg: Dict[str, int] = {l.name: 0 for l in rows}
    for src, dst in edges:
        preds[dst].append(src)
        indeg[dst] += 1
    ready = sorted((name for name, d in indeg.items() if d == 0),
                   key=order.__getitem__)
    succs: Dict[str, List[str]] = {l.name: [] for l in rows}
    for src, dst in edges:
        succs[src].append(dst)
    topo: List[str] = []
    while ready:
        name = min(ready, key=order.__getitem__)
        ready.remove(name)
        topo.append(name)
        for nxt in succs[name]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
    if len(topo) != len(rows):
        cyclic = sorted(
            (n for n, d in indeg.items() if d > 0), key=order.__getitem__
        )
        raise NSOptimizerError(
            f"{dep_path}: dependency cycle through layers {cyclic}"
        )

    by_name = {l.name: l for l in rows}
    sinks = {l.name for l in rows} - {src for src, _ in edges}
    b = GraphBuilder()
    for name in topo:
        layer = by_name[name]
        pkt = f"out:{name}"
        b.packet(pkt, layer.output_bytes, keep=(name in sinks),
                 meta={"layer": name, "memory_bytes": layer.memory_bytes})
        b.task(
            name,
            reads=tuple(f"out:{p}" for p in sorted(preds[name],
                                                   key=order.__getitem__)),
            writes=(pkt,),
            cost=layer.time_s,
        )
    return NSModel(
        graph=b.build(),
        layers=tuple(by_name[name] for name in topo),
        edges=tuple(edges),
    )
