"""Roofline of one step from the ops it dispatches (``repro/launch/roofline.py``).

``repro`` parses the optimized HLO text of a compiled cell. The port has no
HLO: it runs the step once on ``meta`` tensors (no numbers, no memory)
under a ``TorchDispatchMode`` and counts what each dispatched op would do
(:func:`count_step`), into :class:`OpStats`, the counterpart of
``HloStats``:

* ``flops`` — 2·M·N·K for every product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``einsum`` and ``matmul`` reach these), as ``_dot_flops``
  counts a dot, plus each kernel's ``work().flops`` (the products of its
  plain version);
* ``bytes`` — ``repro``'s HBM proxy (``_BYTES_OPS``): the operand and
  output bytes of products, twice the output of a gather (``index``,
  ``gather``, ``index_select``, ``embedding``), twice the update of a
  scatter or an indexed or slice update (``scatter``, ``index_put``,
  ``index_copy``, ``index_add``, a ``copy_`` into part of a tensor), plus
  each kernel's ``work().bytes``; elementwise ops and whole copies are not
  counted, as in ``repro``;
* collective bytes and counts by kind — on a mesh (the step's tensors are
  DTensors, ``launch/steps.py``), each collective a DTensor layout change
  dispatches, under ``repro``'s names (``_COLLECTIVES``) and its byte
  convention: an all-gather its output over the group size, a
  reduce-scatter its output times the group size, the others their output;
  empty on one card;
* ``peak_bytes`` — the most bytes alive at once: the arguments' storages,
  and each storage an op makes, from its dispatch until it is freed (a
  weakref finalizer on the storage), the counterpart of XLA's argument +
  temp sizes;
* ``kernel_calls`` — calls per kernel (``models.common.COUNTED``, whose
  stand-ins add their kernel's work here).

Where a step loops over positions on the host (the sLSTM), a count at full
length is too slow; :func:`fit_quadratic` is the counterpart of ``repro``'s
while-loop trip-count correction: counts at three lengths solved exactly as
a quadratic in the length, checked exactly at a fourth (and at any other
length counted beside them).

**Per device.** A DTensor op is not counted itself: the counter lets
DTensor lay it out (it returns ``NotImplemented`` for DTensor types, as
``CommDebugMode`` does) and counts the ops that run on each device's local
blocks, with the kernels' ``work()`` on local shapes, and the collectives
between them. The count of a sharded step is therefore one device's.

``analyze_hlo``/``HloAnalyzer`` read XLA's text and are not ported. The
roofline's constants are the H100's (``core/cost.py``); the collective
term uses NVLink and is 0 on one card.
"""

from __future__ import annotations

import dataclasses
import weakref
from fractions import Fraction
from typing import Any, Callable, Dict, Iterable, List, Mapping, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.cost import HBM_BW, NVLINK_BW, PEAK_FLOPS
from ..kernels.counted import Work, work_sink

__all__ = ["OpStats", "OpCounter", "count_step", "tensors_of", "storage_bytes", "fit_quadratic",
           "roofline_terms", "dominant_term", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW"]

aten = torch.ops.aten

_PRODUCTS = {aten.mm.default: "mm", aten.addmm.default: "addmm", aten.bmm.default: "bmm",
             aten.baddbmm.default: "baddbmm", aten.mv.default: "mv", aten.dot.default: "dot"}
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
            aten.embedding.default}
# op → the position of its update argument
_SCATTERS = {aten.scatter.src: 3, aten.scatter_.src: 3, aten.scatter_add.default: 3,
             aten.scatter_add_.default: 3, aten.index_put.default: 2,
             aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
             aten.index_copy.default: 3, aten.index_copy_.default: 3,
             aten.index_add.default: 3, aten.index_add_.default: 3}


# Ops whose meta kernels dominate a count's time (a host loop over positions
# dispatches tens of thousands of them), made here from their shapes: see
# _fast_output. Pointwise ops keep their input's floating type; comparisons
# give bool. With FAST_OUTPUTS off every op runs its own meta kernel (the
# tests hold the two counts equal).
FAST_OUTPUTS = True
_POINTWISE = {aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor, aten.div.Tensor,
              aten.add.Scalar, aten.sub.Scalar, aten.mul.Scalar, aten.div.Scalar,
              aten.maximum.default, aten.minimum.default, aten.neg.default, aten.exp.default,
              aten.tanh.default, aten.sigmoid.default, aten.log1p.default, aten.abs.default,
              aten.sgn.default, aten.pow.Tensor_Scalar, aten.clamp.default,
              aten.tanh_backward.default, aten.sigmoid_backward.default,
              aten.log_sigmoid_backward.default, aten.where.self}
_COMPARISONS = {aten.eq.Tensor, aten.ne.Tensor, aten.gt.Tensor, aten.ge.Tensor,
                aten.lt.Tensor, aten.le.Tensor, aten.eq.Scalar, aten.ne.Scalar,
                aten.gt.Scalar, aten.ge.Scalar, aten.lt.Scalar, aten.le.Scalar}


def _row_major(t: torch.Tensor) -> bool:
    """Strides in the order of the dims and none 0 (a contiguous tensor or
    a slice of one)."""
    last = None
    for size, stride in zip(t.shape, t.stride()):
        if size == 1:
            continue
        if stride == 0 or (last is not None and stride > last):
            return False
        last = stride
    return True


def _same_layout(tensors) -> bool:
    """All on ``meta``, of one shape and one floating type, row-major."""
    first = tensors[0]
    return (first.device.type == "meta" and first.dtype.is_floating_point
            and all(t.shape == first.shape and t.dtype == first.dtype and _row_major(t)
                    for t in tensors))


def _fast_output(func, args, kwargs):
    """The output of ``func`` made from its inputs' shapes, or None (its own
    meta kernel then runs):

    * a pointwise op or comparison whose tensors are all on ``meta``, of one
      shape and one floating type and in row-major order (Python numbers
      beside them; ``where``'s condition a bool tensor of that shape): an
      empty contiguous tensor, which is what TensorIterator allocates for
      such inputs, of the input's type (bool for a comparison);
    * ``index`` with one integer index tensor (an embedding lookup): an
      empty contiguous [*index, *rest].
    """
    if func is aten.index.Tensor:
        x, indices = args
        if (len(indices) != 1 or indices[0] is None or x.device.type != "meta"
                or indices[0].dtype not in (torch.int64, torch.int32)):
            return None
        return torch.empty(tuple(indices[0].shape) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
    comparison = func in _COMPARISONS
    if not (comparison or func in _POINTWISE) or any(k != "alpha" for k in kwargs):
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if any(not isinstance(a, (torch.Tensor, int, float)) or isinstance(a, bool)
           for a in args):
        return None
    if func is aten.where.self:
        cond, tensors = tensors[0], tensors[1:]
        if (cond.dtype != torch.bool or cond.device.type != "meta"
                or cond.shape != tensors[0].shape or not _row_major(cond)):
            return None
    if not tensors or not _same_layout(tensors):
        return None
    first = tensors[0]
    return torch.empty(first.shape, dtype=torch.bool if comparison else first.dtype,
                       device=first.device)


def _collective_kinds() -> Dict[Any, str]:
    """{collective op: ``repro``'s kind}: the functional collectives DTensor
    dispatches, and its shard-to-shard move on a CUDA mesh."""
    fn = torch.ops._c10d_functional
    names = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
    out = {getattr(fn, name): kind for name, kind in names.items()}
    alltoall = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    if alltoall is not None:
        out[alltoall] = "all-to-all"
    return out


_COLLECTIVES: Dict[Any, str] = {}


def _group_size(func, args) -> int:
    """The process group's size of a functional collective: its
    ``group_size`` argument, else its named group's."""
    name = func.overloadpacket.__name__
    if name == "all_gather_into_tensor":
        return int(args[1])
    if name == "reduce_scatter_tensor":
        return int(args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()


def _collective_bytes(kind: str, out_bytes: int, group: int) -> float:
    """``repro``'s convention (``repro/launch/roofline.py``): all-gather
    output ÷ group, reduce-scatter output × group, the others output."""
    if kind == "all-gather":
        return out_bytes / max(group, 1)
    if kind == "reduce-scatter":
        return out_bytes * group
    return float(out_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args) -> int:
    """2·M·N·K of one product (a batched one: times its batch)."""
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("mm", "addmm"):
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2 * a.shape[0] * a.shape[1]
    return 2 * a.shape[0]  # dot


@dataclasses.dataclass
class OpStats:
    """One counted step (``repro``'s ``HloStats`` and the sizes of XLA's
    memory analysis). ``ops``: {op: [calls, flops, bytes]}, the table the
    totals are read from."""

    flops: int = 0
    bytes: int = 0
    coll_bytes_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll_bytes_by_kind.values())

    def add(self, op: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.ops.setdefault(op, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


def tensors_of(tree) -> Iterable[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples and modules
    (parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)


def storage_bytes(tree) -> int:
    """The bytes of the storages of ``tree``'s tensors, each storage once."""
    return sum(_storages(tree).values())


def _storages(tree) -> Dict[int, int]:
    out = {}
    for t in tensors_of(tree):
        if type(t).__name__ == "DTensor":  # its block on this device
            t = t._local_tensor
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside the block into :attr:`stats`.
    ``arguments``: the tensors alive before the step, which the peak
    counts from the start and never frees."""

    def __init__(self, arguments=()):
        super().__init__()
        self.stats = OpStats()
        self._live = _storages(arguments)
        self._live_bytes = sum(self._live.values())
        self.stats.argument_bytes = self.stats.peak_bytes = self._live_bytes

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        if self._live_bytes > self.stats.peak_bytes:
            self.stats.peak_bytes = self._live_bytes

    def kernel(self, name: str, work: Work) -> None:
        """The sink of ``COUNTED``'s stand-ins: one call of kernel ``name``."""
        self.stats.kernel_calls[name] = self.stats.kernel_calls.get(name, 0) + 1
        self.stats.add(f"kernel:{name}", work.flops, work.bytes)

    def _collective(self, func, args, out) -> None:
        if not _COLLECTIVES:
            _COLLECTIVES.update(_collective_kinds())
        kind = _COLLECTIVES.get(func.overloadpacket)
        if kind is None:
            return
        b = _collective_bytes(kind, _nbytes(out), _group_size(func, args))
        st = self.stats
        st.coll_bytes_by_kind[kind] = st.coll_bytes_by_kind.get(kind, 0.0) + b
        st.coll_count_by_kind[kind] = st.coll_count_by_kind.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented  # DTensor lays it out; its local ops come back here
        kwargs = kwargs or {}
        if any(t.__name__ == "FakeTensor" for t in types):
            return func(*args, **kwargs)  # DTensor's shape inference, on whole shapes
        if func is aten.log_sigmoid_forward.default:
            # the output and an empty buffer, as the CUDA kernel returns them:
            # the meta kernel follows the CPU's, whose buffer is x's size
            x = args[0]
            o = _fast_output(aten.sigmoid.default, (x,), {}) if FAST_OUTPUTS else None
            out = (func(*args, **kwargs)[0] if o is None else o, x.new_empty(0))
        elif func is aten.log_sigmoid_backward.default and FAST_OUTPUTS:
            # its meta kernel is a Python decomposition: the output is the
            # gradient's, as from a pointwise op on (grad, x)
            g, x = args[0], args[1]
            out = _fast_output(aten.mul.Tensor, (g, x), {})
            if out is None:
                out = func(*args, **kwargs)
        else:
            out = _fast_output(func, args, kwargs) if FAST_OUTPUTS else None
            if out is None:
                out = func(*args, **kwargs)
                if any(type(t).__name__ == "FakeTensor" for t in tree_leaves(out)):
                    return out  # a factory of DTensor's shape inference
        name = _PRODUCTS.get(func)
        if name is not None:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
            self.stats.add(name, _product_flops(name, args), _nbytes(a) + _nbytes(b)
                           + _nbytes(out))
        elif func in _GATHERS:
            self.stats.add(str(func.overloadpacket.__name__), 0, 2 * _nbytes(out))
        elif func in _SCATTERS:
            i = _SCATTERS[func]
            upd = args[i] if len(args) > i else kwargs.get("values", kwargs.get("src"))
            self.stats.add(str(func.overloadpacket.__name__), 0, 2 * _nbytes(upd))
        elif func is aten.copy_.default:
            dst = args[0]
            if _nbytes(dst) < dst.untyped_storage().nbytes():
                self.stats.add("copy_ (slice update)", 0, 2 * _nbytes(dst))
        elif not isinstance(func, torch._ops.HigherOrderOperator):
            self._collective(func, args, out)
        self._track(out)
        return out

    def __enter__(self):
        self._sink = work_sink(self.kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)


def count_step(fn: Callable, *args) -> Tuple[Any, OpStats]:
    """(``fn(*args)``, what it dispatched): ``args`` are the step's
    arguments on ``meta`` (``launch/steps.py``'s ``CellSpec``)."""
    counter = OpCounter(args)
    with counter:
        out = fn(*args)
    return out, counter.stats


def _lagrange(points: Sequence[Tuple[int, int]], x: int) -> Fraction:
    total = Fraction(0)
    for i, (xi, yi) in enumerate(points):
        term = Fraction(yi)
        for j, (xj, _) in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def fit_quadratic(counts: Mapping[int, Mapping[str, int]], at: int) -> Dict[str, int]:
    """Each integer field of ``counts`` ({length: {field: value}}, four
    lengths or more) at length ``at``: the quadratic through the first
    three lengths, solved exactly, must give every other length exactly,
    and its value at ``at`` must be an integer; else ``ValueError``."""
    lengths = sorted(counts)
    if len(lengths) < 4:
        raise ValueError(f"the fit takes counts at four lengths or more, got {lengths}")
    out = {}
    for field in counts[lengths[0]]:
        points = [(s, counts[s][field]) for s in lengths[:3]]
        for check in lengths[3:]:
            got = _lagrange(points, check)
            want = counts[check][field]
            if got != want:
                raise ValueError(f"{field} is not a quadratic in the length: the fit through "
                                 f"{points} gives {got} at {check}, the count {want}")
        value = _lagrange(points, at)
        if value.denominator != 1:
            raise ValueError(f"{field} at {at} is not an integer: {value}")
        out[field] = int(value)
    return out


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float) -> Dict[str, float]:
    """The three roofline times (seconds) of one step on one H100:
    products at ``PEAK_FLOPS`` (bf16), bytes at ``HBM_BW``, collective
    bytes over NVLink (0 on one card)."""
    return {
        "t_compute": flops_per_chip / PEAK_FLOPS,
        "t_memory": bytes_per_chip / HBM_BW,
        "t_collective": coll_bytes_per_chip / NVLINK_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("t_compute", "t_memory", "t_collective"), key=lambda k: terms[k])
