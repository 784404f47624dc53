"""Identity-keyed weak cache for immutable numpy-holding exports.

The CSR export holds numpy fields, so it is unhashable; it is immutable and
created once per graph, so object identity is a sound key as long as id()
reuse after garbage collection is guarded against (liveness-checked weakref,
evicted on collection). Used for the per-export device uploads.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Tuple, TypeVar

T = TypeVar("T")

__all__ = ["weak_id_cache"]


def weak_id_cache(
    store: Dict, obj: object, extra: Tuple, compute: Callable[[], T]
) -> T:
    """Return ``compute()`` memoized per live ``(obj, *extra)``."""
    key = (id(obj), *extra)
    hit = store.get(key)
    if hit is not None and hit[0]() is obj:
        return hit[1]
    value = compute()

    def _evict(_ref, key=key):
        store.pop(key, None)

    store[key] = (weakref.ref(obj, _evict), value)
    return value
