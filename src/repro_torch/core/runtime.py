"""Burst-based application execution (paper Algorithm 1) with device state.

The port of ``repro/core/runtime.py``. Volatile packets live on the
runtime's device as tensors; NVM holds host copies (numpy; a packet may be
a nested dict, such as a serving request's decode state). A load is a
host→device copy, a store a device→host copy, so a "power failure" really
drops the device state, and recovery is "run again from the committed burst
index": bursts are idempotent because tasks are pure functions of their
declared inputs.

    while not done:
        read the committed burst index from NVM
        load the burst's input packets (dependency-optimized) → device
        execute the burst's tasks on device-resident packets only
        store packets needed by later bursts → NVM
        atomically commit index + 1

Each committed burst and each replayed one counts in the process-global
``COMMIT_STATS``; with the tracer on (:data:`repro_torch.obs.trace.TRACER`)
every burst is a span on the runtime track, with ``power_failure``,
``replay`` and ``nvm_commit`` instants inside it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..obs.metrics import METRICS
from ..obs.trace import PID_RUNTIME, TRACER
from .cost import CostModel
from .graph import TaskGraph
from .partition import Partition

__all__ = [
    "PowerFailure",
    "HostTensor",
    "MemoryNVM",
    "DirNVM",
    "BurstRuntime",
    "ExecutionStats",
    "execute_atomic",
    "COMMIT_STATS",
    "reset_commit_stats",
]

# Every committed burst and every replayed one (a re-run of an index whose
# first attempt lost power before the commit), across all runtimes of the
# process. Consumers snapshot and diff; registry-backed, a dict to callers.
COMMIT_STATS = METRICS.counter_dict("runtime.commit_stats", ("commits", "replays"))


def reset_commit_stats() -> None:
    """Zero the process-global commit counters (NVM state and each
    runtime's :class:`ExecutionStats` are untouched)."""
    COMMIT_STATS.reset()


class PowerFailure(RuntimeError):
    """Injected power loss: all volatile state is gone."""


class MemoryNVM:
    """Dict-backed NVM (tests / fault injection)."""

    def __init__(self) -> None:
        self._data: Dict[str, Any] = {}
        self._index: int = 0

    def write(self, name: str, value: Any) -> None:
        self._data[name] = value

    def read(self, name: str) -> Any:
        return self._data[name]

    def has(self, name: str) -> bool:
        return name in self._data

    def read_index(self) -> int:
        return self._index

    def commit_index(self, index: int) -> None:
        self._index = index


class DirNVM:
    """Directory-backed NVM with atomic index commit (rename)."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, name: str) -> str:
        h = hashlib.sha1(name.encode()).hexdigest()[:16]
        return os.path.join(self.path, f"pkt_{h}.pkl")

    def write(self, name: str, value: Any) -> None:
        f = self._file(name)
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(value, fh)
        os.replace(tmp, f)

    def read(self, name: str) -> Any:
        with open(self._file(name), "rb") as fh:
            return pickle.load(fh)

    def has(self, name: str) -> bool:
        return os.path.exists(self._file(name))

    def read_index(self) -> int:
        f = os.path.join(self.path, "burst_index")
        if not os.path.exists(f):
            return 0
        with open(f) as fh:
            return int(fh.read().strip())

    def commit_index(self, index: int) -> None:
        f = os.path.join(self.path, "burst_index")
        fd, tmp = tempfile.mkstemp(dir=self.path)
        with os.fdopen(fd, "w") as fh:
            fh.write(str(index))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, f)


@dataclasses.dataclass(frozen=True, eq=False)
class HostTensor:
    """The NVM copy of a tensor inside a nested packet: its elements as
    numpy (bfloat16 as int16 bits, which numpy lacks) and its torch type."""

    data: np.ndarray
    dtype: torch.dtype


# Torch types numpy has no type for, carried as integer bits of their width.
_BITS_OF = {torch.bfloat16: torch.int16}


def _leaf_to_host(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu", copy=True)
        bits = _BITS_OF.get(t.dtype)
        return HostTensor((t.view(bits) if bits else t).numpy(), t.dtype)
    if isinstance(value, dict):
        return {k: _leaf_to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_leaf_to_host(v) for v in value)
    return value  # numpy arrays and scalars pass through


def _leaf_to_device(value: Any, device: torch.device) -> Any:
    if isinstance(value, HostTensor):
        t = torch.from_numpy(value.data).to(device, copy=True)
        return t.view(value.dtype) if value.dtype in _BITS_OF else t
    if isinstance(value, dict):
        return {k: _leaf_to_device(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_leaf_to_device(v, device) for v in value)
    return value


def _to_device(value: Any, device: torch.device) -> Any:
    """NVM host copy → volatile device state. A packet that is one array
    becomes one tensor; in a packet that is a dict (nesting dicts, lists
    and tuples) each tensor's copy goes back onto ``device`` as a tensor of
    its type, and numpy arrays and scalars stay on the host."""
    if isinstance(value, dict):
        return _leaf_to_device(value, device)
    return torch.from_numpy(np.array(value)).to(device)


def _to_host(value: Any) -> Any:
    """Volatile device state → NVM host copy (picklable, so both NVMs hold
    it). A packet that is one array or tensor becomes one numpy array; a
    dict keeps its nesting, each tensor in it a :class:`HostTensor`."""
    if isinstance(value, dict):
        return _leaf_to_host(value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.array(value)


@dataclasses.dataclass
class ExecutionStats:
    """Observed behaviour, comparable against the model's predictions."""

    bursts_run: int = 0
    tasks_run: int = 0
    bytes_loaded: int = 0
    bytes_stored: int = 0
    energy: float = 0.0  # model-accounted energy of what actually ran
    replays: int = 0     # bursts re-entered after a pre-commit power failure


CrashHook = Callable[[int, str], None]
"""Called at (burst_index, phase) with phase ∈ {'loaded', 'executed', 'stored'};
raise :class:`PowerFailure` to simulate power loss at that point."""


class BurstRuntime:
    """Executes a partitioned task graph per Algorithm 1, on ``device``."""

    def __init__(
        self,
        graph: TaskGraph,
        partition: Partition,
        nvm: Optional[Any] = None,
        cost: Optional[CostModel] = None,
        crash_hook: Optional[CrashHook] = None,
        on_commit: Optional[Callable[[int], None]] = None,
        device="cuda",
    ) -> None:
        partition.validate(graph)
        self.graph = graph
        self.partition = partition
        self.nvm = nvm if nvm is not None else MemoryNVM()
        self.cost = cost
        self.crash_hook = crash_hook
        self.on_commit = on_commit
        self.device = resolve_device(device)
        self.stats = ExecutionStats()
        self._attempted: Set[int] = set()

    def _run_burst(self, b: int) -> None:
        # One span per energy cycle, a power failure as an instant in it;
        # with the tracer off this costs one attribute check.
        if not TRACER.enabled:
            return self._run_burst_impl(b)
        with TRACER.span(
            "burst", cat="runtime", pid=PID_RUNTIME, index=b, replay=b in self._attempted
        ):
            try:
                self._run_burst_impl(b)
            except PowerFailure:
                TRACER.instant("power_failure", cat="runtime", pid=PID_RUNTIME, index=b)
                raise

    def _run_burst_impl(self, b: int) -> None:
        i, j = self.partition.bounds[b]
        g = self.graph
        detail = self.partition.bursts[b]
        volatile: Dict[str, torch.Tensor] = {}
        if b in self._attempted:  # a prior attempt lost power before commit
            self.stats.replays += 1
            COMMIT_STATS["replays"] += 1
            if TRACER.enabled:
                TRACER.instant("replay", cat="runtime", pid=PID_RUNTIME, index=b)
        self._attempted.add(b)

        for name in self._load_set(i, j):
            volatile[name] = _to_device(self.nvm.read(name), self.device)
            self.stats.bytes_loaded += g.packets[name].nbytes
        self._maybe_crash(b, "loaded")

        for k in range(i, j + 1):
            t = g.task(k)
            if t.fn is None:
                raise ValueError(f"task {t.name!r} has no runtime body (fn=None)")
            outputs = t.fn({name: volatile[name] for name in t.reads})
            missing = set(t.writes) - set(outputs)
            if missing:
                raise ValueError(f"task {t.name!r} did not produce {sorted(missing)}")
            for name in t.writes:
                volatile[name] = outputs[name]
            self.stats.tasks_run += 1
        self._maybe_crash(b, "executed")

        for name in self._store_set(i, j):
            self.nvm.write(name, _to_host(volatile[name]))
            self.stats.bytes_stored += g.packets[name].nbytes
        self._maybe_crash(b, "stored")

        self.nvm.commit_index(b + 1)  # linearization point
        self.stats.bursts_run += 1
        COMMIT_STATS["commits"] += 1
        if TRACER.enabled:
            TRACER.instant("nvm_commit", cat="runtime", pid=PID_RUNTIME, index=b)
        if self.cost is not None:
            self.stats.energy += detail.total
        if self.on_commit is not None:
            # after the linearization point: a crash in the observer cannot
            # lose the burst
            self.on_commit(b)
        # power off: the burst's device tensors are dropped on return

    def _load_set(self, i: int, j: int) -> Tuple[str, ...]:
        g = self.graph
        out = []
        seen: Set[str] = set()
        for k in range(i, j + 1):
            t = g.task(k)
            for name, lt in zip(t.reads, g.read_last_touch[k - 1]):
                if lt < i and name not in seen:
                    seen.add(name)
                    out.append(name)
        return tuple(out)

    def _store_set(self, i: int, j: int) -> Tuple[str, ...]:
        g = self.graph
        out = []
        for k in range(i, j + 1):
            for name in g.task(k).writes:
                if g.l_inf[name] > j:
                    out.append(name)
        return tuple(out)

    def _maybe_crash(self, b: int, phase: str) -> None:
        if self.crash_hook is not None:
            self.crash_hook(b, phase)

    def seed_inputs(self, inputs: Mapping[str, Any]) -> None:
        """Place external packets (host values) into NVM before the first
        activation."""
        for name, p in self.graph.packets.items():
            if p.external:
                if name not in inputs:
                    raise ValueError(f"missing external packet {name!r}")
                self.nvm.write(name, _to_host(inputs[name]))

    def step(self) -> bool:
        """Run exactly one uncommitted burst; True once every burst has
        committed. External inputs must already be seeded."""
        b = self.nvm.read_index()
        if b >= self.partition.n_bursts:
            return True
        self._run_burst(b)
        return self.nvm.read_index() >= self.partition.n_bursts

    def run(self, inputs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        """Execute to completion, resuming from the committed burst index."""
        if inputs is not None and self.nvm.read_index() == 0:
            self.seed_inputs(inputs)
        n = self.partition.n_bursts
        b = self.nvm.read_index()
        while b < n:
            self._run_burst(b)
            b = self.nvm.read_index()
        return self.outputs()

    def run_to_completion(
        self, inputs: Optional[Mapping[str, Any]] = None, max_activations: int = 10**6
    ) -> Dict[str, Any]:
        """Like :meth:`run`, but rides through injected power failures."""
        first = True
        for _ in range(max_activations):
            try:
                return self.run(inputs if first else None)
            except PowerFailure:
                first = False
        raise RuntimeError("did not complete within max_activations")

    def outputs(self) -> Dict[str, Any]:
        """Kept packets, as their NVM host copies."""
        return {
            name: self.nvm.read(name)
            for name, p in self.graph.packets.items()
            if p.keep
        }


def execute_atomic(
    graph: TaskGraph, inputs: Mapping[str, Any], device="cuda"
) -> Dict[str, Any]:
    """Reference semantics: the whole application in one uninterrupted pass
    on ``device``; kept packets come back as host copies."""
    dev = resolve_device(device)
    mem: Dict[str, Any] = {k: _to_device(_to_host(v), dev) for k, v in inputs.items()}
    for t in graph.tasks:
        if t.fn is None:
            raise ValueError(f"task {t.name!r} has no runtime body")
        outs = t.fn({name: mem[name] for name in t.reads})
        for name in t.writes:
            mem[name] = outs[name]
    return {name: _to_host(mem[name]) for name, p in graph.packets.items() if p.keep}
