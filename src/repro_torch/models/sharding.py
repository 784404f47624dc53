"""Logical-axis sharding rules (MaxText-style), resolved against a mesh
(``repro/models/sharding.py``).

Every parameter, cache leaf and activation carries *logical* axis names;
a per-family rule table maps each name to mesh axes. Mesh axes the mesh
lacks are dropped, so one table serves the one-pod ``("data", "model")``
mesh, the two-pod ``("pod", "data", "model")`` mesh and a one-device mesh,
where everything resolves to a size-1 axis, i.e. replicated.

Parallelism, as in ``repro``:

* ``batch``    → ("pod", "data")   — data parallel across pods and "data"
* ``d_in``     → ("data",)         — FSDP: weights sharded on their input
                                     dim, gathered where they are used
* ``feat``/``vocab``/``experts`` → ("model",) — tensor (and expert) parallel
* ``act_seq``  → ("model",)        — sequence parallel at layer boundaries
* ``kv_seq``   → ("data", "model") — decode caches sharded along the sequence
* the ssm/hybrid table keeps the sequence local and gives the batch every
  mesh axis that divides it.

A mesh here is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` built with ``mesh_dim_names``,
or a plain ``(names, sizes)`` pair (the resolver needs no devices, so the
production meshes resolve anywhere). :func:`logical_to_spec` gives a tuple
with one entry per tensor dim (``None``, an axis name, or a tuple of
names), ``repro``'s ``PartitionSpec``; :func:`placements` turns it into
DTensor placements.

**The sharded bundle.** :func:`sharded` fills a ``common.Kernels`` bundle
for a model whose tensors are DTensors: each kernel under ``local_map`` on
every device's block, ``repro``'s layout at its sites (``constrain``,
``layout``), and every operation whose layout the mesh decides (a product,
the embedding, the cache writes, the cross-entropy, the blocks that run on
each device's batch block). Every decision that depends on a layout, and
every limit of DTensor that it works round, lives here: the model code
calls the bundle's fields and is the same with or without a mesh. Each
field takes plain tensors as the plain code does (a block run locally
hands the bundle plain tensors).

**The order of a dim split over several mesh axes.** DTensor splits a
tensor dim that several mesh dims shard in the mesh's dim order; JAX splits
it in the spec's order. Where the two differ — the ssm table's ``batch``,
("data", "model", "pod"), on the pod mesh, whose order is ("pod", "data",
"model") — the port takes the mesh's order: each device holds a block of
the same shape as under ``repro``, but not the same block. Every other
spec of either table names its axes in the mesh's order already.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .common import Kernels, softmax_cross_entropy

__all__ = ["Rules", "rules_for", "mesh_axes", "logical_to_spec", "placements",
           "shard_shape", "shardings_for_tree", "constrain", "make_constrain", "is_dtensor",
           "distribute", "local_blocks", "run_local", "sharded", "KV_CACHE", "CROSS_CACHE"]

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple[Any, ...]

# the logical axes of a stacked KV cache leaf [L, B, S, KV, hd]: a self
# cache along the sequence, a cross cache (vision tokens, audio frames) not
KV_CACHE = ("layers", "batch", "kv_seq", "none", "none")
CROSS_CACHE = ("layers", "batch", "none", "none", "none")

_TP_RULES: Rules = {
    "batch": ("pod", "data"),
    "act_seq": ("model",),
    "kv_seq": ("data", "model"),  # decode caches; batch claims "data" first
    "d_in": ("data",),
    "feat": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "none": (),
}

_SSM_RULES: Rules = {
    # the sequence stays local (the recurrence runs along it), so the batch
    # takes every mesh axis that divides it; where it covers too little of
    # the mesh (decode shapes) "model" is left for kv_seq and the cell dims
    "batch": ("data", "model", "pod"),
    "act_seq": (),
    "kv_seq": ("data", "model"),
    "d_in": ("data",),
    "feat": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "none": (),
}


def rules_for(family: str) -> Rules:
    return _SSM_RULES if family in ("ssm", "hybrid") else _TP_RULES


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a ``DeviceMesh`` with ``mesh_dim_names``
    or of a ``(names, sizes)`` pair."""
    if isinstance(mesh, tuple) and len(mesh) == 2:
        names, sizes = mesh
        return tuple(names), tuple(int(s) for s in sizes)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a sharding mesh needs axis names (mesh_dim_names)")
    return tuple(names), tuple(int(s) for s in mesh.shape)


def logical_to_spec(logical: Sequence[Optional[str]], rules: Rules, mesh,
                    shape: Optional[Sequence[int]] = None) -> Spec:
    """Logical axis names (None: replicated) → one entry per tensor dim.

    Left to right, each dim takes those of its rule's mesh axes that are in
    the mesh, not claimed by an earlier dim of the tensor, and (with
    ``shape``) keep dividing the dim: a non-dividing axis is skipped and the
    later ones still tried. Trailing ``None``s are trimmed. An unknown
    logical name raises ``KeyError``."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))
    used: set = set()
    out: list = []
    for i, ax in enumerate(logical):
        if ax is None:
            out.append(None)
            continue
        if ax not in rules:
            raise KeyError(f"unknown logical axis {ax!r}")
        dim = shape[i] if shape is not None and i < len(shape) else None
        chosen: list = []
        prod = 1
        for a in rules[ax]:
            if a not in size or a in used:
                continue
            if dim is not None and dim % (prod * size[a]) != 0:
                continue
            prod *= size[a]
            chosen.append(a)
        if not chosen:
            out.append(None)
            continue
        used.update(chosen)
        out.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names, _ = mesh_axes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return out


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each device's block of a ``shape`` tensor laid out by ``spec``
    (every named axis divides its dim, as the resolver guarantees)."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if out[d] % size[a]:
                raise ValueError(f"axis {a!r} ({size[a]}) does not divide dim {d} of {shape}")
            out[d] //= size[a]
    return tuple(out)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    """A tensor's shape, or the shape of a (shape, dtype) pair."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def shardings_for_tree(logical: Any, tree: Any, rules: Rules, mesh) -> Any:
    """The placements of each leaf of ``tree`` (tensors, or (shape, dtype)
    pairs as ``api.cache_shape`` gives them; dicts nest, None stays None)
    from ``logical``, a tree of the same keys whose leaves are logical
    tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shardings_for_tree(logical[k], v, rules, mesh) for k, v in tree.items()}
    shape = _leaf_shape(tree)
    return placements(logical_to_spec(logical, rules, mesh, shape=shape), mesh)


def is_dtensor(x) -> bool:
    """A DTensor, without importing ``torch.distributed.tensor`` for a
    plain tensor."""
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def constrain(x, rules: Rules, *logical: Optional[str]):
    """``x`` laid out by ``logical`` on its own mesh: the identity unless
    ``x`` is a DTensor on a mesh of more than one device, else
    ``x.redistribute`` to the resolved placements, whose backward lays the
    gradient out as ``x`` was."""
    if not is_dtensor(x) or x.device_mesh.size() == 1:
        return x
    mesh = x.device_mesh
    spec = logical_to_spec(tuple(logical), rules, mesh, shape=tuple(x.shape))
    # redistributed even when already so laid out: the gradient comes back
    # through it in the same layout, whatever the op that read it chose
    return x.redistribute(mesh, placements(spec, mesh))


def distribute(t, logical, rules: Rules, mesh):
    """``t`` (the whole tensor, the same on every process) as a DTensor laid
    out by ``logical``: each device keeps its block, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    spec = logical_to_spec(logical, rules, mesh, shape=tuple(t.shape))
    out = distribute_tensor(t.detach(), mesh, placements(spec, mesh), src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


def local_blocks(shape, dtype, logical, rules: Rules, like, make):
    """A DTensor of ``shape`` on ``like``'s mesh laid out by ``logical``, each
    device's block made by ``make`` on the device of ``like``'s block."""
    from torch.distributed.tensor import DTensor

    mesh = like.device_mesh
    spec = logical_to_spec(logical, rules, mesh, shape=shape)
    local = make(shard_shape(shape, spec, mesh), dtype=dtype,
                 device=like.to_local().device)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_dtensor(tree):
    if is_dtensor(tree):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for v in items:
        found = _first_dtensor(v)
        if found is not None:
            return found
    return None


class _swapped:
    """``module``'s parameters named in ``values`` replaced by those tensors
    inside the block (autograd flows through them to the originals)."""

    def __init__(self, module, values):
        self.slots = []
        for name, t in values.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            self.slots.append((mod, leaf, t))

    def __enter__(self):
        self.saved = [(mod, leaf, mod._parameters[leaf]) for mod, leaf, _ in self.slots]
        for mod, leaf, t in self.slots:
            mod._parameters[leaf] = t

    def __exit__(self, *exc):
        for mod, leaf, p in self.saved:
            mod._parameters[leaf] = p


def run_local(fn, module, *args, means: Sequence[int] = ()):
    """``fn(*args)`` on each device's batch block, for a block of code whose
    ops DTensor cannot lay out (routing, a recurrence over positions).

    The first DTensor among ``args`` sets the layout: its dim-0 (batch)
    shards stay, every other shard or partial sum of every DTensor in
    ``args`` (trees of dicts, tuples and lists; each tensor's dim 0 the
    batch) is gathered, and ``module``'s DTensor parameters are gathered
    whole. ``fn`` runs on the local tensors and its outputs, batch first,
    come back as DTensors of the same batch layout, except the outputs at
    the positions ``means``: each device's mean over its own block, which
    come back averaged over the batch shards (replicated once read).
    Without a DTensor in ``args`` this is ``fn(*args)``. Gradients of the
    gathered parameters are summed over the batch shards."""
    x = _first_dtensor(args)
    if x is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    batch = [p if p.is_shard() and p.dim == 0 else Replicate() for p in x.placements]
    n_shards = 1
    for i, p in enumerate(batch):
        if p.is_shard():
            n_shards *= mesh.size(i)
    summed = [Partial() if p.is_shard() else Replicate() for p in batch]
    rep = [Replicate()] * mesh.ndim

    def local(t):
        if not is_dtensor(t):
            return t
        if t.dim() == 0:
            return t.redistribute(mesh, rep).to_local()
        return t.redistribute(mesh, batch).to_local()

    params = {} if module is None else {
        name: p.redistribute(mesh, rep).to_local(grad_placements=summed)
        for name, p in module.named_parameters() if is_dtensor(p)}
    with _swapped(module, params):
        out = fn(*_tree_map(local, args))

    def back(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, batch, run_check=False)

    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o / n_shards, mesh, summed, run_check=False)
                     if i in means else _tree_map(back, o) for i, o in enumerate(out))
    return _tree_map(back, out)


def make_constrain(rules: Rules) -> Callable[[torch.Tensor], torch.Tensor]:
    """``repro``'s layout at its sites (``launch/steps.py:26`` there): a
    [B, S, d] activation as ("batch", "act_seq", None), q/k/v [B, S, H, hd]
    as ("batch", "act_seq", None, None), anything else as it is."""
    def c(x):
        if x.dim() == 3:
            return constrain(x, rules, "batch", "act_seq", None)
        if x.dim() == 4:
            return constrain(x, rules, "batch", "act_seq", None, None)
        return x
    return c


# -- the sharded bundle ---------------------------------------------------------

def _placements_keeping(t, keep) -> list:
    """``t``'s placements with each ``Shard(d)`` kept where ``keep(d)``,
    every other placement (a shard elsewhere, a partial sum) made
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard() and keep(p.dim) else Replicate() for p in t.placements]


def _replicated(t, mesh):
    """``t`` as a DTensor on ``mesh``: a plain tensor replicated, a DTensor
    gathered."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    if isinstance(t, DTensor):
        return t.redistribute(mesh, rep)
    return DTensor.from_local(t, mesh, rep, run_check=False)


def _local(fn, out, ins, mesh, grads=None):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out, in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)


def _sharded_rmsnorm(fn):
    def call(x, w, eps):
        if not is_dtensor(x):
            return fn(x, w, eps)
        from torch.distributed.tensor import Partial

        # the normalized (last) dim is never sharded; the weight's gradient
        # is each device's partial sum over its rows
        mesh, last = x.device_mesh, x.dim() - 1
        xp = _placements_keeping(x, lambda d: d != last)
        w = _replicated(w, mesh)
        w_grad = [Partial() if p.is_shard() else p for p in xp]
        return _local(fn, xp, (xp, list(w.placements), None), mesh,
                      grads=(xp, w_grad, None))(x, w, eps)
    return call


def _split_ok(t, placements, dim: int) -> bool:
    """Every mesh dim that ``placements`` shards ``dim`` on divides it
    together."""
    mesh, n = t.device_mesh, 1
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            n *= mesh.size(i)
    return t.shape[dim] % n == 0


def _sharded_attention(fn):
    def call(q, k, v, causal):
        if not is_dtensor(q):
            return fn(q, k, v, causal)
        from torch.distributed.tensor import Replicate, Shard

        # a batch shard common to q, k and v stays; every other mesh axis
        # of more than one device splits the heads when it divides them,
        # else q, k and v are whole there: a sequence shard (act_seq,
        # kv_seq) or a partial sum is never passed in
        mesh = q.device_mesh
        k, v = (t if is_dtensor(t) else _replicated(t, mesh) for t in (k, v))
        n_heads, n_kv = q.shape[2], k.shape[2]
        want, split = [], 1
        for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements, v.placements)):
            if pq.is_shard() and pq.dim == 0 and pq == pk == pv:
                want.append(pq)
            elif mesh.size(i) > 1 and n_heads % (split * mesh.size(i)) == 0:
                split *= mesh.size(i)
                want.append(Shard(2))
            else:
                want.append(Replicate())
        if n_kv % split:
            # each device's query heads read a block of the key/value heads
            # only if those split too: else every query head gets its own copy
            k, v = (t.repeat_interleave(n_heads // n_kv, dim=2) for t in (k, v))
        return _local(lambda q_, k_, v_: fn(q_, k_, v_, causal), want,
                      (want, want, want), mesh)(q, k, v)
    return call


def _sharded_mlstm(fn):
    def call(q, k, v, i_pre, f_pre):
        if not is_dtensor(q):
            return fn(q, k, v, i_pre, f_pre)
        from torch.distributed.tensor import Replicate, Shard

        # batch (dim 0) and heads (dim 2) may stay sharded
        mesh = q.device_mesh
        ins = [t if is_dtensor(t) else _replicated(t, mesh) for t in (q, k, v, i_pre, f_pre)]
        want = [p if p.is_shard() and p.dim in (0, 2) and all(p == t.placements[i]
                                                              for t in ins)
                else Replicate() for i, p in enumerate(q.placements)]
        if not all(_split_ok(t, want, 2) for t in ins):
            want = [p if p.is_shard() and p.dim == 0 else Replicate() for p in want]
        state = [Shard(1) if p.is_shard() and p.dim == 2 else p for p in want]
        return _local(fn, (want, state, state, state), tuple([want] * 5), mesh)(*ins)
    return call


def _rows_local(x) -> bool:
    """A DTensor x [..., d] whose rows a product should take on each device:
    split along a middle dim (the sequence) over a mesh axis of more than
    one device, or split along its leading dims over every such axis (no
    axis left to split the product's features)."""
    if not is_dtensor(x) or x.dim() < 3:
        return False
    mesh, last = x.device_mesh, x.dim() - 1
    big = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    rows = [i for i in big if x.placements[i].is_shard() and x.placements[i].dim != last]
    return bool(big) and (rows == big or any(x.placements[i].dim > 0 for i in rows))


def _matmul(x, w) -> torch.Tensor:
    """``x @ w`` (x [..., d], w [d, f]). Where :func:`_rows_local` holds, each
    device takes its block of rows against the whole weight (gathered), the
    layout kept and each gradient handed back in it: a DTensor product
    would fold a split batch and sequence into one dim, which not every
    DTensor release can do, or hand its input's gradient back split along
    the features, which a later view into heads may not take. The same
    products either way; the weight's gradient is each device's partial
    sum."""
    if not _rows_local(x):
        return x @ w
    from torch.distributed.tensor import Partial

    mesh, last = x.device_mesh, x.dim() - 1
    xp = _placements_keeping(x, lambda d: d != last)
    w = _replicated(w, mesh)
    w_grad = [Partial() if p.is_shard() else p for p in xp]
    return _local(torch.matmul, xp, (xp, list(w.placements)), mesh, grads=(xp, w_grad))(x, w)


def _heads(y, n_heads: int, head_dim: int) -> torch.Tensor:
    """A projection [..., n_heads · head_dim] split into heads, a feature
    shard gathered first: a DTensor cannot split a sharded feature dim into
    heads that the mesh axis does not divide."""
    if is_dtensor(y):
        last = y.dim() - 1
        y = y.redistribute(y.device_mesh, _placements_keeping(y, lambda d: d != last))
    return y.unflatten(-1, (n_heads, head_dim))


def _embed(w, tokens) -> torch.Tensor:
    """The rows of ``w`` [V, d] at ``tokens``. A DTensor table is looked up
    on each device's blocks (``local_map``): its feature dim gathered, its
    vocabulary split as it is, each device's tokens read from its own
    vocabulary block (zero outside it) and the rows summed over the
    vocabulary's devices (a partial sum, reduced where it is laid out)."""
    if not is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import Partial, Replicate

    mesh = w.device_mesh
    w = w.redistribute(mesh, _placements_keeping(w, lambda d: d == 0))
    tokens = tokens if is_dtensor(tokens) else _replicated(tokens, mesh)
    tp = [p if p.is_shard() and p.dim == 0 and not w.placements[i].is_shard() else Replicate()
          for i, p in enumerate(tokens.placements)]
    vocab = [i for i, p in enumerate(w.placements) if p.is_shard() and mesh.size(i) > 1]
    rows, first = w.shape[0], 0
    for i in vocab:  # this device's first vocabulary row
        rows //= mesh.size(i)
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= rows
    out = [Partial() if i in vocab else p for i, p in enumerate(tp)]
    w_grad = [p if p.is_shard() else (Partial() if tp[i].is_shard() else Replicate())
              for i, p in enumerate(w.placements)]

    def lookup(tok, table):
        if not vocab:
            return table[tok]
        local = tok - first
        inside = (local >= 0) & (local < rows)
        return table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)

    return _local(lookup, out, (tp, list(w.placements)), mesh,
                  grads=(tp, w_grad))(tokens, w)


def _new_cache(shapes, like, logical, rules: Rules, make=torch.zeros):
    """A cache tree from its {leaf: (shape, dtype)} tree (None stays None):
    ``make`` tensors on ``like``'s device; when ``like`` is a DTensor,
    DTensors on its mesh laid out by ``logical`` (a tree of the same keys)
    under ``rules``, each device making only its block."""
    if shapes is None:
        return None
    if isinstance(shapes, dict):
        return {k: _new_cache(v, like, logical[k], rules, make) for k, v in shapes.items()}
    shape, dtype = shapes
    if not is_dtensor(like):
        return make(shape, dtype=dtype, device=like.device)
    return local_blocks(shape, dtype, logical, rules, like, make)


def _write_prefix(cache, i: int, kv) -> None:
    """``cache[i, :, :S] = kv`` (kv [B, S, ...]); a DTensor cache takes kv
    padded with zeros to its length, as ``repro`` pads, since a slice of a
    sharded sequence is no view."""
    if not is_dtensor(cache):
        cache[i, :, :kv.shape[1]] = kv
        return
    from torch.distributed.tensor import DTensor

    # padded on each device's batch block (the sequence gathered), then laid
    # out as the cache by the copy
    mesh = kv.device_mesh
    kv = kv.redistribute(mesh, _placements_keeping(kv, lambda d: d == 0))
    pad = [0, 0] * (kv.dim() - 2) + [0, cache.shape[2] - kv.shape[1]]
    local = torch.nn.functional.pad(kv.to_local(), pad).to(cache.dtype)
    cache[i].copy_(DTensor.from_local(local, mesh, kv.placements, run_check=False))


def _write_at(cache, pos, new) -> None:
    """``cache[:, pos] = new[:, 0]`` in place (cache [B, S, ...], pos a 0-d
    int64 tensor); a DTensor cache by ``repro``'s one-hot select, which
    keeps every device on its own block of a sharded sequence."""
    if not is_dtensor(cache):
        cache.index_copy_(1, pos.view(1), new)
        return
    hit = (torch.arange(cache.shape[1], device=pos.device) == pos).view(
        1, -1, *([1] * (cache.dim() - 2)))
    cache.copy_(torch.where(hit, new.to(cache.dtype), cache))


def _cross_entropy(logits, labels) -> torch.Tensor:
    """``common.softmax_cross_entropy`` of DTensor logits [B, S, V] on each
    device's block, every shard of B and S kept. Where a mesh axis of more
    than one device splits the vocabulary, the logsumexp and the label's
    logit are reduced over it (a max, then sums, ``repro``'s vocab-parallel
    reduction); else each block runs the plain function. The blocks' means
    are averaged (all blocks hold as many tokens), a replicated 0-d DTensor."""
    if not is_dtensor(logits):
        return softmax_cross_entropy(logits, labels)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, last = logits.device_mesh, logits.dim() - 1
    keep = _placements_keeping(logits, lambda d: True)
    vocab = [i for i, p in enumerate(keep) if p.is_shard() and p.dim == last
             and mesh.size(i) > 1]
    rows = [p if p.is_shard() and p.dim != last else Replicate() for p in keep]
    if not vocab:
        keep = rows
    x = logits.redistribute(mesh, keep).to_local().to(torch.float32)
    y = labels.redistribute(mesh, rows).to_local() if is_dtensor(labels) else labels
    if vocab:
        def reduced(t, op):
            spread = [Partial(op) if i in vocab else p for i, p in enumerate(rows)]
            return DTensor.from_local(t, mesh, spread, run_check=False).redistribute(
                mesh, rows).to_local()

        width = x.shape[-1]
        first = 0
        for i in vocab:  # this device's first vocabulary entry
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        first *= width
        top = reduced(x.detach().amax(dim=-1, keepdim=True), "max")
        lse = top[..., 0] + torch.log(reduced(torch.exp(x - top).sum(dim=-1), "sum"))
        y = y.to(torch.int64) - first
        inside = (y >= 0) & (y < width)
        picked = torch.gather(x, -1, y.clamp(0, width - 1)[..., None])[..., 0]
        picked = reduced(torch.where(inside, picked, torch.zeros_like(picked)), "sum")
        mean = (lse - picked).mean()
    else:
        mean = softmax_cross_entropy(x, y)
    blocks = 1
    for i, p in enumerate(rows):
        if p.is_shard():
            blocks *= mesh.size(i)
    spread = [Partial() if p.is_shard() else Replicate() for p in rows]
    return DTensor.from_local(mean / blocks, mesh, spread, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def _decode_attention(fn, q, cache_k, cache_v, visible):
    """One query position against a DTensor cache: on each device's batch
    block (:func:`run_local`, the plain code on local tensors) unless a mesh
    axis of more than one device splits the cache's sequence; then as
    DTensor ops, the softmax's sums reduced across the split."""
    seq_split = is_dtensor(cache_k) and any(
        p.is_shard() and p.dim == 1 and cache_k.device_mesh.size(i) > 1
        for i, p in enumerate(cache_k.placements))
    if seq_split:
        return fn(q, cache_k, cache_v, visible)
    return run_local(fn, None, q, cache_k, cache_v, visible)


def sharded(kernels: Kernels, rules: Rules) -> Kernels:
    """``kernels`` for a model whose tensors are DTensors laid out under
    ``rules`` (the family's :func:`rules_for`): each kernel runs on every
    device's block under ``local_map`` (a plain tensor passes straight
    through), ``constrain`` and ``layout`` lay activations out at
    ``repro``'s sites, and the other fields take DTensors (module
    docstring). What each kernel takes: RMSNorm any layout but a sharded
    normalized dim; flash attention and the mLSTM shards of batch or heads
    (common to all their inputs and dividing the heads), every other shard
    gathered first. The launches inside see only local tensors, so on a
    card they are the CUDA kernels on each block."""
    return Kernels(
        rmsnorm=_sharded_rmsnorm(kernels.rmsnorm),
        attention=_sharded_attention(kernels.attention),
        mlstm=_sharded_mlstm(kernels.mlstm),
        constrain=make_constrain(rules),
        layout=lambda x, *logical: constrain(x, rules, *logical),
        matmul=_matmul, heads=_heads, embed=_embed,
        new_cache=lambda shapes, like, logical, make=torch.zeros: _new_cache(
            shapes, like, logical, rules, make),
        write_prefix=_write_prefix, write_at=_write_at, cross_entropy=_cross_entropy,
        local=run_local, decode_attention=_decode_attention)
