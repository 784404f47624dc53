"""Ladybirds-style task-graph specification model (paper §3).

The port's own copy of ``repro/core/graph.py``: the same SSA packets and
tasks, the same §4.2 analysis products (``writer``, ``l_inf``,
``read_last_touch``), and the same CSR slot export, so a graph built here
exports array-for-array what the reference exports. Host-side numpy,
float64 — no device work happens in this module.

Indices are 1-based (task 1 .. n_t), as in the paper; 0 is the virtual
"before the application" state, and ``l_inf == n_t + 1`` marks kept outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Packet",
    "Task",
    "TaskGraph",
    "GraphBuilder",
    "GraphCSRArrays",
    "graph_from_description",
]


@dataclasses.dataclass(frozen=True)
class Packet:
    """A fixed-size unit of data exchanged between tasks.

    ``c0_weight`` scales the fixed (per-DMA-initiation) component of the
    transfer cost; sub-packets of one coalesced array use ``1/len(array)``.
    """

    name: str
    nbytes: int
    c0_weight: float = 1.0
    keep: bool = False          # application output: must survive the last burst
    external: bool = False      # present in NVM before the application starts

    def __post_init__(self) -> None:
        if self.nbytes < 0:
            raise ValueError(f"packet {self.name!r}: negative size")


@dataclasses.dataclass(frozen=True)
class Task:
    """One atomic kernel invocation (paper: a *task*)."""

    name: str
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    cost: float
    fn: Optional[Callable[..., Mapping[str, Any]]] = None  # runtime body

    def __post_init__(self) -> None:
        if self.cost < 0:
            raise ValueError(f"task {self.name!r}: negative cost")
        if len(set(self.writes)) != len(self.writes):
            raise ValueError(f"task {self.name!r}: duplicate writes")
        if len(set(self.reads)) != len(self.reads):
            raise ValueError(f"task {self.name!r}: duplicate reads")
        if set(self.reads) & set(self.writes):
            raise ValueError(
                f"task {self.name!r}: packet both read and written — model "
                "'inout' as a read of the old version plus a write of a new one (SSA)"
            )


@dataclasses.dataclass(frozen=True)
class GraphCSRArrays:
    """Compressed slot export of a :class:`TaskGraph`.

    Task ``j`` (1-based) owns read slots ``read_ptr[j-1]:read_ptr[j]`` and
    write slots ``write_ptr[j-1]:write_ptr[j]``, in declaration order. Byte
    counts stay cost-model-independent; they are priced at solve time
    (:mod:`repro_torch.kernels.partition_sweep.ref`).
    """

    n_tasks: int
    e_task: np.ndarray        # (N,)      f64  task execution cost
    read_ptr: np.ndarray      # (N+1,)    i32  row pointers into the read slots
    read_bytes: np.ndarray    # (nnz_r,)  f64  |p| per read slot
    read_c0w: np.ndarray      # (nnz_r,)  f64  c0_weight per read slot
    read_lt: np.ndarray       # (nnz_r,)  i32  l_j(p): last touch strictly before j
    read_writer: np.ndarray   # (nnz_r,)  i32  writer(p) (0 = external)
    read_linf: np.ndarray     # (nnz_r,)  i32  l_∞(p) of the read packet
    write_ptr: np.ndarray     # (N+1,)    i32
    write_bytes: np.ndarray   # (nnz_w,)  f64
    write_c0w: np.ndarray     # (nnz_w,)  f64
    write_linf: np.ndarray    # (nnz_w,)  i32

    @property
    def n_pad(self) -> int:
        return int(self.e_task.shape[-1])

    @property
    def nnz_reads(self) -> int:
        return int(self.read_bytes.shape[-1])

    @property
    def nbytes(self) -> int:
        """Total bytes of the export."""
        return int(
            sum(
                getattr(self, f.name).nbytes
                for f in dataclasses.fields(self)
                if f.name != "n_tasks"
            )
        )


class TaskGraph:
    """A validated sequential application with explicit data dependencies."""

    def __init__(self, tasks: Sequence[Task], packets: Iterable[Packet]):
        self.tasks: List[Task] = list(tasks)
        self.packets: Dict[str, Packet] = {}
        for p in packets:
            if p.name in self.packets:
                raise ValueError(f"duplicate packet {p.name!r}")
            self.packets[p.name] = p
        self._validate()
        self._analyze()

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def task(self, index: int) -> Task:
        """1-based task accessor (paper notation)."""
        return self.tasks[index - 1]

    def _validate(self) -> None:
        writer: Dict[str, int] = {}
        for p in self.packets.values():
            if p.external:
                writer[p.name] = 0
        for idx, t in enumerate(self.tasks, start=1):
            for name in t.reads:
                if name not in self.packets:
                    raise ValueError(f"task {t.name!r} reads unknown packet {name!r}")
                if name not in writer:
                    raise ValueError(
                        f"task {t.name!r} (index {idx}) reads packet {name!r} "
                        "before it is written"
                    )
            for name in t.writes:
                if name not in self.packets:
                    raise ValueError(f"task {t.name!r} writes unknown packet {name!r}")
                if name in writer:
                    raise ValueError(
                        f"packet {name!r} written twice (SSA violation): "
                        f"by task {writer[name]} and task {idx}"
                    )
                writer[name] = idx
        for p in self.packets.values():
            if p.name not in writer:
                raise ValueError(f"packet {p.name!r} is never written and not external")
        self._writer = writer

    def _analyze(self) -> None:
        n = self.n_tasks
        l_inf: Dict[str, int] = {name: self._writer[name] for name in self.packets}
        for idx, t in enumerate(self.tasks, start=1):
            for name in t.reads:
                l_inf[name] = max(l_inf[name], idx)
        for p in self.packets.values():
            if p.keep:
                l_inf[p.name] = n + 1
        self.l_inf = l_inf

        # The paper's l_k(p): last touch strictly before k (0 = never).
        last_touch: Dict[str, Optional[int]] = {
            name: (0 if self.packets[name].external else None)
            for name in self.packets
        }
        self.read_last_touch: List[Tuple[int, ...]] = []
        for idx, t in enumerate(self.tasks, start=1):
            row = []
            for name in t.reads:
                lt = last_touch[name]
                if lt is None:  # _validate guarantees written-before-read
                    raise AssertionError(f"packet {name!r} read before written")
                row.append(lt)
            self.read_last_touch.append(tuple(row))
            for name in t.reads:
                last_touch[name] = idx
            for name in t.writes:
                last_touch[name] = idx

    def writer(self, packet: str) -> int:
        """Index of the task writing ``packet`` (0 = external)."""
        return self._writer[packet]

    def total_task_cost(self) -> float:
        """E_app: the cost of executing all tasks with no partitioning overhead."""
        return float(sum(t.cost for t in self.tasks))

    def total_packet_bytes(self) -> int:
        """Static size of all application data (the Single Task baseline)."""
        return int(sum(p.nbytes for p in self.packets.values()))

    def to_csr_arrays(self) -> GraphCSRArrays:
        """Export the §4.2 analysis products in the compressed slot layout
        (cached: graphs are immutable once built)."""
        cached = getattr(self, "_csr_cache", None)
        if cached is not None:
            return cached
        r_ptr = [0]
        rb: List[float] = []
        rc0: List[float] = []
        rlt: List[int] = []
        rwr: List[int] = []
        rli: List[int] = []
        w_ptr = [0]
        wb: List[float] = []
        wc0: List[float] = []
        wli: List[int] = []
        for idx, t in enumerate(self.tasks):
            for name, lt in zip(t.reads, self.read_last_touch[idx]):
                p = self.packets[name]
                rb.append(p.nbytes)
                rc0.append(p.c0_weight)
                rlt.append(lt)
                rwr.append(self._writer[name])
                rli.append(self.l_inf[name])
            r_ptr.append(len(rb))
            for name in t.writes:
                p = self.packets[name]
                wb.append(p.nbytes)
                wc0.append(p.c0_weight)
                wli.append(self.l_inf[name])
            w_ptr.append(len(wb))

        out = GraphCSRArrays(
            n_tasks=self.n_tasks,
            e_task=np.array([t.cost for t in self.tasks], dtype=np.float64),
            read_ptr=np.array(r_ptr, dtype=np.int32),
            read_bytes=np.array(rb, dtype=np.float64),
            read_c0w=np.array(rc0, dtype=np.float64),
            read_lt=np.array(rlt, dtype=np.int32),
            read_writer=np.array(rwr, dtype=np.int32),
            read_linf=np.array(rli, dtype=np.int32),
            write_ptr=np.array(w_ptr, dtype=np.int32),
            write_bytes=np.array(wb, dtype=np.float64),
            write_c0w=np.array(wc0, dtype=np.float64),
            write_linf=np.array(wli, dtype=np.int32),
        )
        self._csr_cache = out
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"TaskGraph(n_tasks={self.n_tasks}, n_packets={len(self.packets)})"


class GraphBuilder:
    """Incremental builder mirroring a Ladybirds metakernel."""

    def __init__(self) -> None:
        self._packets: List[Packet] = []
        self._tasks: List[Task] = []

    def packet(self, name: str, nbytes: int, **kw: Any) -> str:
        self._packets.append(Packet(name, nbytes, **kw))
        return name

    def packet_array(self, name: str, count: int, nbytes_each: int, **kw: Any) -> List[str]:
        """A contiguous array of ``count`` sub-packets with amortized DMA init."""
        w = 1.0 / count
        return [
            self.packet(f"{name}[{i}]", nbytes_each, c0_weight=w, **kw)
            for i in range(count)
        ]

    def task(
        self,
        name: str,
        reads: Sequence[str] = (),
        writes: Sequence[str] = (),
        cost: float = 0.0,
        fn: Optional[Callable[..., Mapping[str, Any]]] = None,
    ) -> None:
        self._tasks.append(Task(name, tuple(reads), tuple(writes), float(cost), fn))

    def build(self) -> TaskGraph:
        return TaskGraph(self._tasks, self._packets)


def graph_from_description(
    packets: Iterable[Mapping[str, Any]], tasks: Iterable[Mapping[str, Any]]
) -> TaskGraph:
    """A :class:`TaskGraph` from plain records — how a graph crosses from
    another implementation without sharing its objects.

    ``packets``: mappings with ``name, nbytes, c0_weight, keep, external``;
    ``tasks``: mappings with ``name, reads, writes, cost``, in task order.
    """
    pk = [
        Packet(
            str(p["name"]), int(p["nbytes"]), float(p["c0_weight"]),
            keep=bool(p["keep"]), external=bool(p["external"]),
        )
        for p in packets
    ]
    ts = [
        Task(str(t["name"]), tuple(t["reads"]), tuple(t["writes"]), float(t["cost"]))
        for t in tasks
    ]
    return TaskGraph(ts, pk)
