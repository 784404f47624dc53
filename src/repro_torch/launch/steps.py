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

The train step is ``launch/train.py::train_step``; prefill and decode are
``api.prefill`` and ``api.decode_step`` on ``KERNELS``. There are no
shardings and no ``make_constrain``: ``repro`` lays its arrays out over a
TPU pod's mesh, the identity on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..models import api
from ..models.common import COUNTED, KERNELS, Kernels
from ..optim.adamw import AdamWConfig, adamw_init
from .roofline import OpStats, count_step
from .train import stand_ins, train_step

__all__ = ["CellSpec", "build_cell"]

META = torch.device("meta")


@dataclasses.dataclass
class CellSpec:
    """One countable and runnable (arch × shape) cell on one card.

    ``fn(*args, kernels=...)`` runs the step; ``args`` are on ``meta``;
    ``alias`` are the positions of the arguments the step updates in place.
    The card runs ``KERNELS``, the count ``COUNTED`` (the train step runs
    the plain versions under either)."""

    cfg: ModelConfig
    shape: ShapeConfig
    device: torch.device
    fn: Callable
    args: Tuple[Any, ...]
    alias: Tuple[int, ...] = ()

    def count(self) -> Tuple[Any, OpStats]:
        """(the step's outputs on ``meta``, what it dispatched)."""
        return count_step(lambda *a: self.fn(*a, kernels=COUNTED), *self.args)

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
            return model, state, batch
        model = api.init_params(cfg, seed, dev, max_seq=s)
        if shape.kind == "prefill":
            return model, {"tokens": ids((b, s)), **stand_ins(cfg, b, dev)}
        cache = _tensors(api.cache_shape(cfg, b, s), torch.zeros, dev)
        pos = torch.full((), s - 1, dtype=api.TOKEN_DTYPE, device=dev)
        return model, cache, ids((b, 1)), pos

    def run(self, args) -> Any:
        """One step on materialized ``args`` with the card's kernels."""
        return self.fn(*args, kernels=KERNELS)


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


def build_cell(cfg: ModelConfig, shape: ShapeConfig, device="cuda",
               adamw: Optional[AdamWConfig] = None, remat: bool = True) -> CellSpec:
    """The cell's step and abstract arguments. ``device`` is where
    :meth:`CellSpec.run` runs it (a CUDA request without a card raises);
    ``adamw`` and ``remat`` shape the train step (``repro``'s defaults)."""
    dev = resolve_device(device)
    max_seq = shape.seq_len
    specs = api.input_specs(cfg, shape)

    if shape.kind == "train":
        adamw = adamw or AdamWConfig()
        model, masters = api.init_trainable(cfg, None, META, max_seq=max_seq)
        state = {"params": masters, "opt_state": adamw_init(masters)}

        def step(model, state, batch, kernels: Kernels):
            del kernels  # the loss runs the plain versions, as the port trains
            return train_step(cfg, model, state, adamw, batch, remat=remat)

        return CellSpec(cfg, shape, dev, step, (model, state, _empty(specs)), alias=(0, 1))

    model = api.init_params(cfg, None, META, max_seq=max_seq)
    if shape.kind == "prefill":
        def step(model, batch, kernels: Kernels):
            return api.prefill(cfg, model, batch, max_seq, kernels)

        return CellSpec(cfg, shape, dev, step, (model, _empty(specs)))

    if shape.kind == "decode":
        def step(model, cache, token, pos, kernels: Kernels):
            return api.decode_step(cfg, model, cache, token, pos, kernels)

        args = (model, _empty(specs["cache"]), _empty(specs["token"]), _empty(specs["pos"]))
        return CellSpec(cfg, shape, dev, step, args, alias=(1,))

    raise ValueError(f"unknown shape kind {shape.kind!r}")
