"""The kernels' work, for counting a step without running it.

Each model kernel has a ``work(...)`` beside its wrapper (in its
``ops.py``), which gives the :class:`Work` of one call from its shapes, and
a counted stand-in, which takes ``meta`` tensors only, adds that work to
the active count and returns empty outputs of the kernel's shapes and
types. ``models.common.COUNTED`` is the set of stand-ins;
``launch.roofline`` opens the count (:func:`work_sink`). A stand-in given a
CPU or CUDA tensor raises: it computes nothing, so no result may come of it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import torch

__all__ = ["Work", "work_sink", "add_work"]


class Work(NamedTuple):
    """One kernel call's work.

    ``flops``: 2·M·N·K for every product the kernel's plain version
    computes (what a count of the plain version gives); ``bytes``: its
    inputs read once and its outputs written once; ``ops``: the operations
    these inputs need, which the card's bound counts (a causal attention's
    visible pairs only, for example)."""

    flops: int
    bytes: int
    ops: int


_SINK: contextvars.ContextVar[Optional[Callable[[str, Work], None]]] = (
    contextvars.ContextVar("kernel_work_sink", default=None))


@contextlib.contextmanager
def work_sink(sink: Callable[[str, Work], None]) -> Iterator[None]:
    """Inside the block, every counted stand-in calls ``sink(kernel name,
    its work)`` in this thread."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def add_work(name: str, tensors: Iterable[torch.Tensor], work: Work) -> None:
    """Adds ``work`` to the active count; raises unless every tensor is on
    ``meta`` and a count is open."""
    for t in tensors:
        if t.device.type != "meta":
            raise RuntimeError(f"{name}: the counted stand-in takes meta tensors only, got "
                               f"one on {t.device} (it computes nothing; run KERNELS or "
                               "PLAIN on a real device)")
    sink = _SINK.get()
    if sink is None:
        raise RuntimeError(f"{name}: no count is open (launch.roofline.count_step)")
    sink(name, work)
