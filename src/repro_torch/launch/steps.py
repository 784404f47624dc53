"""Step builders of the dry run: one (arch × shape) cell's step and its
arguments (``repro/launch/steps.py``).

``build_cell`` returns a :class:`CellSpec`: the step function, its abstract
arguments (the model built without numbers on ``meta``, the train state,
the inputs of ``api.input_specs``) and which arguments the step updates in
place (``alias``, the meaning of ``repro``'s ``donate_argnums``: the decode
cache; the train module, masters and moments). The counterpart of
``lower()``/``compile()`` is :meth:`CellSpec.count`, a count of the step on
``meta`` through ``launch/roofline.py`` with the kernels' stand-ins
(``COUNTED``; train: the plain versions, as the port trains); and
:meth:`CellSpec.materialize` makes real arguments on the cell's device from
a seed, to run one step (:meth:`CellSpec.run`).

**The compiled step.** ``repro``'s ``CellSpec.jitted()`` is ``jax.jit``
with the cell's shardings and ``donate_argnums``. Here :meth:`CellSpec.run`
on a card is the replay of one CUDA graph per (cell, model, input shapes)
(:meth:`CellSpec.replay`) through the serving and training graphs,
``serve._GraphedPrefill``, ``serve._GraphedDecode`` and
``train._GraphedTrainStep``, each capturing the cell's own eager step
(:meth:`CellSpec.run_eager`) with ``serve._capture`` and keeping its graphs
in a ``WeakKeyDictionary`` on the model, so that they go when the model
does. The static inputs are the prefill's batch and the decode's cache,
token and 0-d position; the decode graph updates its own cache in place,
which each call's cache is copied into and back out of, so that the
caller's cache is updated in place as the eager step updates it (one
graph serves any number of caches). The train graph's static input is
the batch; the module and the train state are closed over and updated
in place, and a call whose state holds other tensors than at the capture
raises. A shape's first call runs the eager step on a side stream, whose
result it returns, then captures; ``serve.TRACE_COUNT`` (train:
``train.TRACE_COUNT["step"]``) counts captures. A failed capture raises:
nothing falls back to the eager step, which stays reachable as
:meth:`CellSpec.run_eager`, the reference of the bitwise checks. On the
CPU :meth:`CellSpec.run` is the eager step.

The train step is ``launch/train.py::train_step``; prefill and decode are
``api.prefill`` and ``api.decode_step`` on ``KERNELS``.

**Sharded cells.** With a ``mesh`` (a ``DeviceMesh`` with axis names,
``launch/mesh.py``) every argument is a DTensor laid out as ``repro``'s
``in_shardings`` lay it out: the module's parameters, the float32 masters
and AdamW's moments by ``api.param_logical``, the inputs along the batch
(``_batch_sharding``), the decode cache by ``api.cache_logical``; the step
returns the logits laid out as ("batch", None, "vocab") and the cache by
its logical axes. The step runs under ``implicit_replication`` (a plain
tensor made inside it counts as replicated; ``sharding.mesh_scope``), through
``sharding.sharded(kernels, rules)``: every kernel on each device's block,
the layout constraints at ``repro``'s sites (``make_constrain``).
:attr:`CellSpec.placements` keeps each argument's and output's
placements. Counted on ``meta`` under a fake process group
(``mesh.count_mesh``), the step's numbers are per device; materialized
on cards (``mesh.make_host_mesh``), each process holds its blocks. On a
card a sharded cell is a graph too: its static inputs are DTensors, each
call's inputs are copied into each device's block, and a replay runs the
local kernels and the NCCL collectives the capture recorded. Without a
mesh nothing of this runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..models import api
from ..models.common import COUNTED, KERNELS, PLAIN, Kernels
from ..models.sharding import (Rules, constrain, distribute, is_dtensor, logical_to_spec,
                               make_constrain, mesh_scope, placements, rules_for, sharded,
                               shardings_for_tree)
from ..optim.adamw import AdamWConfig, adamw_init
from . import serve
from .roofline import OpStats, count_step
from .train import _GraphedTrainStep, stand_ins, train_step

__all__ = ["CellSpec", "build_cell", "make_constrain", "shard_batch", "LOGITS_LOGICAL"]

META = torch.device("meta")
LOGITS_LOGICAL = ("batch", None, "vocab")


def _batch_logical(shape) -> Tuple[Optional[str], ...]:
    return ("batch",) + (None,) * (len(shape) - 1)


@dataclasses.dataclass
class CellSpec:
    """One countable and runnable (arch × shape) cell, on one card or laid
    out over ``mesh``.

    ``fn(*args, kernels=...)`` runs the step; ``args`` are on ``meta``;
    ``alias`` are the positions of the arguments the step updates in place.
    The card runs ``KERNELS``, the count ``COUNTED`` (the train step runs
    the plain versions under either), each through ``sharding.sharded`` on a
    mesh. ``placements`` (on a mesh): {"args": each argument's placements,
    "outputs": the logits' and the cache's (train: the loss's)}."""

    cfg: ModelConfig
    shape: ShapeConfig
    device: torch.device
    fn: Callable
    args: Tuple[Any, ...]
    alias: Tuple[int, ...] = ()
    mesh: Any = None
    placements: Optional[Dict[str, Any]] = None
    _graph: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def _kernels(self, kernels: Kernels) -> Kernels:
        if self.mesh is None:
            return kernels
        return sharded(kernels, rules_for(self.cfg.family))

    def _scope(self):
        return mesh_scope(self.mesh)

    def count(self) -> Tuple[Any, OpStats]:
        """(the step's outputs on ``meta``, what it dispatched; per device
        on a mesh)."""
        kernels = self._kernels(COUNTED)
        with self._scope():
            return count_step(lambda *a: self.fn(*a, kernels=kernels), *self.args)

    def alias_args(self) -> Tuple[Any, ...]:
        return tuple(self.args[i] for i in self.alias)

    def materialize(self, seed: int = 0) -> Tuple[Any, ...]:
        """The arguments on the cell's device: the model's weights from
        ``seed`` (``api.init_params``/``init_trainable``), token ids drawn
        from a generator seeded with ``seed`` + 1, the modality stand-ins and
        the decode cache zeros, a decode at the last position."""
        cfg, shape, dev = self.cfg, self.shape, self.device
        b, s = shape.global_batch, shape.seq_len
        gen = torch.Generator(device=dev).manual_seed(seed + 1)

        def ids(shape_):
            return torch.randint(0, cfg.vocab, shape_, generator=gen, device=dev,
                                 dtype=api.TOKEN_DTYPE)

        if shape.kind == "train":
            model, masters = api.init_trainable(cfg, seed, dev, max_seq=s)
            state = {"params": masters, "opt_state": adamw_init(masters)}
            batch = {"tokens": ids((b, s)), "labels": ids((b, s)), **stand_ins(cfg, b, dev)}
            return self.shard((model, state, batch))
        model = api.init_params(cfg, seed, dev, max_seq=s)
        if shape.kind == "prefill":
            return self.shard((model, {"tokens": ids((b, s)), **stand_ins(cfg, b, dev)}))
        cache = _tensors(api.cache_shape(cfg, b, s), torch.zeros, dev)
        pos = torch.full((), s - 1, dtype=api.TOKEN_DTYPE, device=dev)
        return self.shard((model, cache, ids((b, 1)), pos))

    def shard(self, args) -> Tuple[Any, ...]:
        """Whole arguments (as :meth:`materialize` makes them, the same on
        every process) laid out on the cell's mesh: each process keeps its
        blocks; the arguments themselves without a mesh."""
        if self.mesh is None:
            return tuple(args)
        return _lay_out(self.cfg, self.shape, self.mesh, tuple(args))

    def run(self, args) -> Any:
        """One step on materialized ``args`` with the card's kernels, the
        counterpart of ``repro``'s ``CellSpec.jitted()``: on a card the
        replay of the cell's CUDA graph (:meth:`replay`), on the CPU the
        eager step (:meth:`run_eager`)."""
        if self.device.type == "cuda":
            return self.replay(args)
        return self.run_eager(args)

    def run_eager(self, args) -> Any:
        """One eager step on ``args``: the reference the graphed step is
        held to."""
        kernels = self._kernels(KERNELS)
        with self._scope():
            return self.fn(*args, kernels=kernels)

    def _graphed(self):
        """The cell's graphed step, made on first use: the serving or the
        training graph of :meth:`run_eager`."""
        if self._graph is None:
            cfg, dev, kind = self.cfg, self.device, self.shape.kind

            def eager(*args):
                return self.run_eager(args)

            if kind == "train":
                self._graph = _GraphedTrainStep(cfg, None, dev, step=eager)
            elif kind == "prefill":
                self._graph = serve._GraphedPrefill(cfg, dev, None, step=eager)
            else:
                self._graph = serve._GraphedDecode(cfg, dev, True, step=eager)
        return self._graph

    def graphs(self, model) -> Dict[tuple, "serve._Captured"]:
        """{key: the captured step} of ``model`` in this cell, for the
        captures' stats."""
        return self._graphed().graphs(model)

    def replay(self, args) -> Any:
        """The step as one CUDA graph per (model, input shapes) (module
        docstring): a shape's first call captures and returns the warm-up's
        result; later calls copy their inputs in and replay. Returns what
        the eager step returns: the prefill's logits and cache (clones),
        the decode's logits (a clone) and the caller's cache, updated in
        place, the train step's loss (a clone)."""
        graph = self._graphed()
        if self.shape.kind != "decode":
            return graph(*args)
        cache = args[1]
        logits, own = graph(*args)
        serve._feed(cache, own, "cache")  # back into the caller's cache
        return logits, cache


def _tensors(tree, make: Callable, dev):
    """A (shape, dtype) tree (``api.input_specs``, ``api.cache_shape``) as
    ``make(shape, dtype=, device=dev)`` tensors; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tensors(v, make, dev) for k, v in tree.items()}
    shape, dtype = tree
    return make(shape, dtype=dtype, device=dev)


def _empty(tree):
    """A (shape, dtype) tree as empty ``meta`` tensors."""
    return _tensors(tree, torch.empty, META)


def _shard_tree(tree, logical_of, rules: Rules, mesh):
    """Each tensor of a dict tree as a DTensor laid out by ``logical_of(path,
    tensor)`` (a 0-d tensor replicated); None stays None."""
    def one(path, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: one(path + (k,), v) for k, v in t.items()}
        return distribute(t, logical_of(path, t) if t.dim() else (), rules, mesh)
    return one((), tree)


def _shard_module(model: torch.nn.Module, logical: Dict[str, tuple], rules: Rules, mesh):
    """Every parameter of ``model`` replaced in place by a DTensor parameter
    laid out by ``logical`` (``api.param_logical``), keeping requires_grad."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = distribute(p.data, logical[name], rules, mesh)
        mod._parameters[leaf] = torch.nn.Parameter(d, requires_grad=p.requires_grad)
    return model


def shard_batch(cfg, batch, mesh):
    """Inputs (a dict tree of tensors, the same on every process) as
    DTensors along the batch, ``repro``'s ``_batch_sharding``."""
    return _shard_tree(batch, lambda path, t: _batch_logical(t.shape), rules_for(cfg.family),
                       mesh)


def _lay_out(cfg, shape: ShapeConfig, mesh, args) -> Tuple[Any, ...]:
    """A cell's whole arguments as DTensors on ``mesh`` (``repro``'s
    ``in_shardings``): the train cell's (model, state, batch) with the
    masters and moments laid out as their parameters; the prefill's
    (model, batch); the decode's (model, cache, token, pos)."""
    rules = rules_for(cfg.family)
    logical = api.param_logical(cfg, args[0])
    model = _shard_module(args[0], logical, rules, mesh)

    def batch(path, t):
        return _batch_logical(t.shape)

    if shape.kind == "train":
        state = args[1]

        def by_name(path, t):
            return logical[path[-1]]

        sharded_state = {"params": _shard_tree(state["params"], by_name, rules, mesh),
                         "opt_state": {"m": _shard_tree(state["opt_state"]["m"], by_name,
                                                        rules, mesh),
                                       "v": _shard_tree(state["opt_state"]["v"], by_name,
                                                        rules, mesh),
                                       "step": state["opt_state"]["step"]}}
        return model, sharded_state, _shard_tree(args[2], batch, rules, mesh)
    if shape.kind == "prefill":
        return model, _shard_tree(args[1], batch, rules, mesh)
    cache_l = api.cache_logical(cfg, shape.global_batch, shape.seq_len)

    def by_cache(path, t):
        node = cache_l
        for k in path:
            node = node[k]
        return node

    cache, token, pos = args[1:]
    return (model, _shard_tree(cache, by_cache, rules, mesh),
            _shard_tree(token, batch, rules, mesh), pos)


def _placements_of(tree):
    """The placements of each DTensor of an argument tree (parameters by
    name; a plain tensor None)."""
    if isinstance(tree, torch.nn.Module):
        return {n: tuple(p.placements) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _placements_of(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_placements_of(v) for v in tree]
    return tuple(tree.placements) if is_dtensor(tree) else None


def _output_placements(cfg, shape: ShapeConfig, mesh, max_seq: int) -> Dict[str, Any]:
    """``repro``'s ``out_shardings`` as placements: the logits ("batch",
    None, "vocab") and the cache by ``api.cache_logical`` (train: the loss,
    replicated; the state as it came in)."""
    rules = rules_for(cfg.family)
    if shape.kind == "train":
        return {"loss": tuple(placements((), mesh))}
    b = shape.global_batch
    logits = placements(logical_to_spec(LOGITS_LOGICAL, rules, mesh, (b, 1, cfg.vocab)), mesh)
    cache = shardings_for_tree(api.cache_logical(cfg, b, max_seq),
                               api.cache_shape(cfg, b, max_seq), rules, mesh)
    return {"logits": tuple(logits), "cache": cache}


def build_cell(cfg: ModelConfig, shape: ShapeConfig, device="cuda",
               adamw: Optional[AdamWConfig] = None, remat: bool = True,
               mesh=None, max_seq: Optional[int] = None) -> CellSpec:
    """The cell's step and abstract arguments. ``device`` is where
    :meth:`CellSpec.run` runs it (a CUDA request without a card raises);
    ``adamw`` and ``remat`` shape the train step (``repro``'s defaults);
    ``mesh`` lays the cell out over a device mesh (module docstring), None
    keeps it whole on one device; ``max_seq`` (default: the shape's
    length) is the length a prefill pads its cache to, so that decode steps
    can follow it."""
    dev = resolve_device(device)
    max_seq = shape.seq_len if max_seq is None else max_seq
    specs = api.input_specs(cfg, shape)
    rules = rules_for(cfg.family)

    def finish(out):
        """The step's logits laid out as ("batch", None, "vocab") on a mesh."""
        if mesh is None or not is_dtensor(out[0]):
            return out
        logits = constrain(out[0], rules, *LOGITS_LOGICAL)
        return (logits,) + tuple(out[1:])

    if shape.kind == "train":
        adamw = adamw or AdamWConfig()
        model, masters = api.init_trainable(cfg, None, META, max_seq=max_seq)
        state = {"params": masters, "opt_state": adamw_init(masters)}

        def step(model, state, batch, kernels: Kernels):
            # the loss runs the plain versions, as the port trains
            plain = PLAIN if mesh is None else sharded(PLAIN, rules)
            return train_step(cfg, model, state, adamw, batch, remat=remat, kernels=plain)

        args, alias = (model, state, _empty(specs)), (0, 1)
    else:
        model = api.init_params(cfg, None, META, max_seq=max_seq)
        if shape.kind == "prefill":
            def step(model, batch, kernels: Kernels):
                return finish(api.prefill(cfg, model, batch, max_seq, kernels))

            args, alias = (model, _empty(specs)), ()
        elif shape.kind == "decode":
            def step(model, cache, token, pos, kernels: Kernels):
                return finish(api.decode_step(cfg, model, cache, token, pos, kernels))

            args = (model, _empty(specs["cache"]), _empty(specs["token"]), _empty(specs["pos"]))
            alias = (1,)
        else:
            raise ValueError(f"unknown shape kind {shape.kind!r}")
    cell = CellSpec(cfg, shape, dev, step, args, alias=alias, mesh=mesh)
    if mesh is not None:
        cell.args = cell.shard(args)
        cell.placements = {"args": _placements_of(list(cell.args)),
                           "outputs": _output_placements(cfg, shape, mesh, max_seq)}
    return cell
