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
the embedding, the cache writes, the cross-entropy, the MoE block's
experts, the Mamba2 cell's heads, the blocks that run on each device's
batch block). Where ``repro``'s partitioned HLO splits work over "model",
so does the bundle: the experts (an all-to-all of the tokens), attention's
query rows where the heads do not divide the axis, the Mamba2 state's
heads, and a product whose weight and input are whole on an axis; where
that HLO keeps work whole on each "model" device (the sLSTM recurrence),
the bundle runs it on each device's batch block too
(``tests/test_torch_sharding.py`` holds the two per device). Every decision that depends on a layout, and
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

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .common import COMPUTE_DTYPE, Kernels, softmax_cross_entropy
from .ssm import CONV_K, Mamba2, mamba_dims

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


def mesh_scope(mesh):
    """The scope a step on ``mesh`` runs in: ``implicit_replication`` (a
    plain tensor made inside the step counts as replicated); without a mesh
    nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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


def run_local(fn, module, *args, means: Sequence[int] = (), weights=None):
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
    gathered parameters are summed over the batch shards. ``weights``: the
    names of the only parameters ``fn`` reads (default: every one)."""
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
        for name, p in module.named_parameters()
        if is_dtensor(p) and (weights is None or name in weights)}
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


def _sharded_attention(fn, row_axes: Sequence[str]):
    def call(q, k, v, causal):
        if not is_dtensor(q):
            return fn(q, k, v, causal)
        from torch.distributed.tensor import Partial, Replicate, Shard

        # a batch shard common to q, k and v stays; every other mesh axis
        # of more than one device splits the heads when it divides them,
        # else, on an axis in ``row_axes``, splits q's rows (repro's
        # act_seq; q's own sequence shard, or
        # q whole there cut into blocks, the last ones short where the axis
        # does not divide the sequence, as XLA pads): each device its query
        # rows from its q_start against k and v whole; a key sequence shard
        # or a partial sum is never passed in
        mesh = q.device_mesh
        names, _ = mesh_axes(mesh)
        k, v = (t if is_dtensor(t) else _replicated(t, mesh) for t in (k, v))
        n_heads, n_kv = q.shape[2], k.shape[2]
        want, want_kv, split, rows = [], [], 1, []
        for i, (pq, pk, pv) in enumerate(zip(q.placements, k.placements, v.placements)):
            if pq.is_shard() and pq.dim == 0 and pq == pk == pv:
                want.append(pq)
            elif mesh.size(i) > 1 and n_heads % (split * mesh.size(i)) == 0:
                split *= mesh.size(i)
                want.append(Shard(2))
            elif (mesh.size(i) > 1 and not rows and names[i] in row_axes
                  and (pq.is_replicate() or pq == Shard(1))):
                rows.append(i)
                want.append(Shard(1))
            else:
                want.append(Replicate())
            want_kv.append(Replicate() if i in rows else want[-1])
        if n_kv % split:
            # each device's query heads read a block of the key/value heads
            # only if those split too: else every query head gets its own copy
            k, v = (t.repeat_interleave(n_heads // n_kv, dim=2) for t in (k, v))
        if not rows:
            return _local(lambda q_, k_, v_: fn(q_, k_, v_, causal), want,
                          (want, want, want), mesh)(q, k, v)
        # this device's rows: ceil(S / n) from its first (the last ones short
        # or empty where n does not divide S); k's and v's gradients are
        # each device's partial sums over its rows
        from torch.distributed.tensor import DTensor

        (i,) = rows
        n, seq = mesh.size(i), q.shape[1]
        per = -(-seq // n)
        first = min(mesh.get_local_rank(i) * per, seq)
        kv_grad = [Partial() if j == i else p for j, p in enumerate(want_kv)]
        kl, vl = (t.redistribute(mesh, want_kv).to_local(grad_placements=kv_grad)
                  for t in (k, v))
        if seq % n == 0:
            ql = q.redistribute(mesh, want).to_local(grad_placements=want)
            return DTensor.from_local(fn(ql, kl, vl, causal, q_start=first), mesh, want,
                                      run_check=False)
        # uneven: no DTensor block of another length; q whole there, each
        # device its rows, the output gathered back whole (padded to n
        # equal blocks), each device's gradient its own rows
        whole = [Replicate() if j == i else p for j, p in enumerate(want)]
        ql = q.redistribute(mesh, whole).to_local(
            grad_placements=[Partial() if j == i else p for j, p in enumerate(whole)])
        o = fn(ql.narrow(1, first, min(per, seq - first)), kl, vl, causal, q_start=first)
        o = torch.nn.functional.pad(o, (0, 0, 0, 0, 0, per - o.shape[1]))
        o = _Gather.apply(o.contiguous(), 1, mesh.get_group(i), True).narrow(1, 0, seq)
        return DTensor.from_local(o.contiguous(), mesh, whole, run_check=False)
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


def _split_free(x, w, free_axes: Sequence[str]):
    """(x, w) for ``x @ w`` (x [..., d], w [d, f]) with the product split
    over every mesh axis in ``free_axes`` (those ``repro``'s rules give the
    features) of more than one device that holds both whole,
    where no layout splits it and it would run whole on each of the axis'
    devices: x's leading rows (the batch, else the sequence) where the axis
    divides them, else w's output features where it divides them, else the
    input features (the product a partial sum) where it divides those, else
    the output features unevenly (as XLA pads); local splits, no
    collective. For one position (a decode step), where x's rows are
    split, w's input features are gathered there first."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return x, w
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    names, _ = mesh_axes(mesh)
    xp, wp, rows = list(x.placements), list(w.placements), 1
    seq = any(p.is_shard() and p.dim == 1 for p in xp)
    for i, p in enumerate(xp):
        if p.is_shard() and p.dim == 0:
            rows *= mesh.size(i)
    for i in range(mesh.ndim):
        if xp[i] == Shard(0) and wp[i] == Shard(0) and x.dim() > 2 and x.shape[1] == 1:
            # one position: the weight's input features gathered where x's
            # rows are split (FSDP), where DTensor would move the few rows
            # into a split of the features and leave a partial sum
            wp[i] = Replicate()
        if (names[i] not in free_axes or mesh.size(i) == 1
                or not (xp[i].is_replicate() and wp[i].is_replicate())):
            continue
        if x.dim() > 1 and x.shape[0] % (rows * mesh.size(i)) == 0:
            rows *= mesh.size(i)
            xp[i] = Shard(0)
        elif x.dim() > 2 and not seq and x.shape[1] % mesh.size(i) == 0:
            seq, xp[i] = True, Shard(1)
        elif w.shape[-1] % mesh.size(i) and w.shape[0] % mesh.size(i) == 0:
            xp[i], wp[i] = Shard(x.dim() - 1), Shard(0)   # a partial sum
        else:
            wp[i] = Shard(w.dim() - 1)
    return x.redistribute(mesh, xp), w.redistribute(mesh, wp)


def _matmul(x, w, free_axes: Sequence[str] = ()) -> torch.Tensor:
    """``x @ w`` (x [..., d], w [d, f]), split by :func:`_split_free`
    where no layout splits it. Where :func:`_rows_local` holds, each
    device takes its block of rows against the whole weight (gathered), the
    layout kept and each gradient handed back in it: a DTensor product
    would fold a split batch and sequence into one dim, which not every
    DTensor release can do, or hand its input's gradient back split along
    the features, which a later view into heads may not take. The same
    products either way; the weight's gradient is each device's partial
    sum."""
    x, w = _split_free(x, w, free_axes)
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


def _decode_attention(fn, q, cache_k, cache_v, visible, free_axes: Sequence[str] = ()):
    """One query position against a DTensor cache: where a mesh axis of more
    than one device splits the cache's sequence, as DTensor ops, the
    softmax's sums reduced across the split; else on each device's batch
    block (:func:`run_local`, the plain code on local tensors). A mesh axis
    in ``free_axes`` of more than one device that holds the cache and the
    query whole (a cross cache) first takes the batch where it divides it,
    else the cache's sequence (unevenly where it does not divide it, as XLA
    pads): each device its block, no collective."""
    if not is_dtensor(cache_k):
        return run_local(fn, None, q, cache_k, cache_v, visible)
    from torch.distributed.tensor import Shard

    mesh = cache_k.device_mesh
    if not is_dtensor(q):
        q = _replicated(q, mesh)
    qp, cp, rows = list(q.placements), list(cache_k.placements), 1
    for i, p in enumerate(cp):
        if p.is_shard() and p.dim == 1 and mesh.size(i) > 1:
            return fn(q, cache_k, cache_v, visible)
        if p.is_shard() and p.dim == 0:
            rows *= mesh.size(i)
    seq, names = False, mesh_axes(mesh)[0]
    for i in range(mesh.ndim):
        if (names[i] not in free_axes or mesh.size(i) == 1
                or not (cp[i].is_replicate() and qp[i].is_replicate())):
            continue
        if q.shape[0] % (rows * mesh.size(i)) == 0:
            rows *= mesh.size(i)
            qp[i] = cp[i] = Shard(0)
        elif not seq:
            seq, cp[i] = True, Shard(1)
    q = q.redistribute(mesh, qp)
    cache_k, cache_v = (t.redistribute(mesh, cp) for t in (cache_k, cache_v))
    if seq:
        return fn(q, cache_k, cache_v, visible)
    return run_local(fn, None, q, cache_k, cache_v, visible)


class _AllToAll(torch.autograd.Function):
    """``t`` [n, ...] cut into its n blocks along dim 0, block i sent to rank
    i of ``group``; block i of the result came from rank i. The gradient
    goes back the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(t, group):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_to_all_single(t.contiguous(), None, None, group))


class _Gather(torch.autograd.Function):
    """``t``'s blocks along ``dim`` over ``group``, joined in rank order.
    Its gradient: each rank's own block of the group's sum (a
    reduce-scatter), the gradients being each rank's partial sums; with
    ``whole`` (the gradient the same whole on every rank, as of a
    replicated result), each rank's own block of it."""

    @staticmethod
    def forward(ctx, t, dim, group, whole=False):
        ctx.dim, ctx.group, ctx.whole = dim % t.dim(), group, whole
        return _gathered(t, ctx.dim, group)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol

        if ctx.whole:
            n = grad.shape[ctx.dim] // ctx.group.size()
            rank = ctx.group.rank()
            return grad.narrow(ctx.dim, rank * n, n), None, None, None
        scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
        out = scatter(grad.contiguous(), "sum", ctx.dim, ctx.group)
        return funcol.wait_tensor(out), None, None, None


def _gathered(t, dim: int, group):
    """``t``'s blocks along ``dim`` over ``group``, joined in rank order (no
    gradient)."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(t.detach().contiguous(), dim, group))


def _experts(moe, x, means: bool = False):
    """The MoE block (``moe.MoE._block``) on DTensors. Where a mesh axis of
    more than one device splits the experts (``repro``'s "experts" →
    "model"), each device computes only its own experts' slots
    (:func:`_expert_parallel`); else the block runs on each device's batch
    block with the experts gathered whole (:func:`run_local`). A plain
    tensor runs the plain block."""
    if not is_dtensor(x) or not is_dtensor(moe.w1):
        return moe._block(x, means)
    mesh = x.device_mesh
    split = [i for i, p in enumerate(moe.w1.placements)
             if p.is_shard() and p.dim == 0 and mesh.size(i) > 1]
    if split:
        return _expert_parallel(moe, x, split[0], means)
    if means:
        return run_local(lambda x_: moe._block(x_, means=True), moe, x, means=(1,))
    return run_local(moe._block, moe, x)


def _expert_parallel(moe, x, ep: int, means: bool):
    """Expert parallelism over mesh dim ``ep``, ``repro``'s layout
    (``repro/models/moe.py:78-88``). Each device keeps x's batch shards and,
    on ``ep``, its sequence shard or the whole tokens. The routing is
    ``repro``'s on whole token groups: the router probabilities of a
    sequence shard are gathered over ``ep`` first, each device routes the
    groups (top-k, queue positions) and keeps its own tokens' choices.

    * tokens split over ``ep``: each device scatters its tokens into the
      (expert, slot) rows of its groups, the rows go to their experts'
      devices by one all-to-all (each slot holds one token, so the blocks
      received add up to the slots' rows), each device runs its experts,
      and a second all-to-all brings every expert's rows back, where each
      device picks its own tokens' choices;
    * tokens whole on ``ep``: each device takes its experts' slots from its
      own tokens, and its combine, of its experts' choices only, is a
      float32 partial sum over ``ep``.

    The load-balance loss's means are each device's means over its own
    tokens, averaged over the devices that split the tokens (a partial
    sum). Gradients: each weight's local block gets its device's share,
    summed over the batch shards; the experts' blocks stay split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .moe import (GROUP_SIZE, Routing, balance_means, combine, expert_ffn, moe_capacity,
                      slot_rows)

    m = moe.cfg.moe
    mesh, group = x.device_mesh, x.device_mesh.get_group(ep)
    n_ep, j = mesh.size(ep), mesh.get_local_rank(ep)
    e, k, d = m.n_experts, m.top_k, x.shape[-1]
    e_l, gsz = e // n_ep, min(GROUP_SIZE, x.shape[1])
    pe = x.placements[ep]
    tok = pe.dim if pe.is_shard() and pe.dim in (0, 1) and x.shape[pe.dim] % n_ep == 0 else None
    batch = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == 0 and i != ep]
    xp = [Shard(0) if i in batch else (Shard(tok) if i == ep and tok is not None else Replicate())
          for i in range(mesh.ndim)]
    parts = [i for i in range(mesh.ndim) if i in batch or i == ep]
    summed = [Partial() if i in parts else Replicate() for i in range(mesh.ndim)]
    xg = [Partial() if i == ep and tok is None else p for i, p in enumerate(xp)]
    xl = x.redistribute(mesh, xp).to_local(grad_placements=xg)
    # the router's products split as the experts where the tokens are whole
    cols = [Shard(1) if i == ep and tok is None else Replicate() for i in range(mesh.ndim)]
    router = moe.router.redistribute(mesh, cols).to_local(
        grad_placements=[Shard(1) if i == ep and tok is None else p
                         for i, p in enumerate(summed)])
    own = [Shard(0) if i == ep else Replicate() for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i == ep else p for i, p in enumerate(summed)]
    w1, w3, w2 = (w.redistribute(mesh, own).to_local(grad_placements=w_grad)
                  for w in (moe.w1, moe.w3, moe.w2))

    def router_probs():
        logits = xl @ router
        if tok is None:
            logits = _Gather.apply(logits, -1, group)
        return torch.softmax(logits.to(torch.float32), dim=-1)

    probs = router_probs()                                              # own tokens
    rows = probs.detach() if tok is None else _gathered(probs, tok, group)
    bb, ss = rows.shape[:2]
    r = moe.route_probs(rows.reshape(bb * ss // gsz, gsz, e))
    c = moe_capacity(m, gsz)
    first = 0 if tok is None else j * xl.shape[tok]

    def mine(t):  # own tokens' entries of a [G, group, ...] routing tensor
        t = t.reshape(bb, ss, *t.shape[2:])
        return t if tok is None else t.narrow(tok, first, xl.shape[tok])

    sel, pos, kept = mine(r.sel), mine(r.pos), mine(r.kept)
    gate = torch.gather(probs, -1, sel)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    ro = Routing(sel, gate, pos, kept)
    groups = bb * ss // gsz
    gidx = mine(torch.arange(bb * ss, device=xl.device).reshape(groups, gsz) // gsz)
    flat = (gidx[..., None] * (e * c + 1) + slot_rows(ro, e, c)).reshape(-1)

    src = xl[..., None, :].expand(*xl.shape[:-1], k, d).reshape(-1, d)
    buf = xl.new_zeros(groups * (e * c + 1), d).scatter(0, flat[:, None].expand(-1, d), src)
    buf = buf.view(groups, e * c + 1, d)[:, :e * c].reshape(groups, n_ep, e_l * c, d)
    if tok is None:
        xe = buf[:, j]
    else:
        xe = _AllToAll.apply(buf.transpose(0, 1), group).sum(dim=0)
    xe = xe.reshape(groups, e_l, c, d).transpose(0, 1).reshape(e_l, groups * c, d)
    ye = expert_ffn(xe, w1, w3, w2).reshape(e_l, groups, c, d).transpose(0, 1).reshape(
        groups, 1, e_l * c, d)
    if tok is None:
        back = torch.nn.functional.pad(ye, (0, 0, 0, 0, j, n_ep - 1 - j))
    else:
        back = _AllToAll.apply(ye.transpose(0, 1).expand(n_ep, groups, e_l * c, d),
                               group).transpose(0, 1)
    back = torch.cat([back.reshape(groups, e * c, d), back.new_zeros(groups, 1, d)], dim=1)
    picked = back.reshape(-1, d)[flat].reshape(*xl.shape[:-1], k, d)
    if tok is None:
        y32 = combine(picked, ro, torch.float32)
        y = DTensor.from_local(y32, mesh, [Partial() if i == ep else p for i, p in enumerate(xp)],
                               run_check=False).redistribute(mesh, xp).to(COMPUTE_DTYPE)
    else:
        y = DTensor.from_local(combine(picked, ro), mesh, xp, run_check=False)
    if not means:
        return y
    n_parts = 1
    for i in parts:
        n_parts *= mesh.size(i)
    # the router again, as the plain block takes it
    local = torch.stack(balance_means(router_probs(), sel)) / n_parts
    return y, DTensor.from_local(local, mesh, summed, run_check=False)


def _ssd(cell, x, state=None, decode: bool = False, rules: Rules = None):
    """The Mamba2 cell (``ssm.Mamba2``: its prefill, or with ``decode`` its
    step) on DTensors. Where a mesh axis of more than one device holds x
    whole and divides the heads, the state's width 2N and the chunk,
    ``repro``'s split of the state's "feat" (the axes ``rules`` give it):
    each device computes its heads (:func:`_ssd_heads`); else on each
    device's batch block (:func:`run_local`). A plain tensor runs the plain
    cell."""
    run = cell.decode if decode else cell
    if not is_dtensor(x):
        return run(x, state)
    from .ssm import mamba_chunk_len, mamba_dims

    mesh = x.device_mesh
    names, _ = mesh_axes(mesh)
    _, H, _, N = mamba_dims(cell.cfg)
    for i, p in enumerate(x.placements):
        m = mesh.size(i)
        if (names[i] in rules["feat"] and m > 1 and p.is_replicate() and H % m == 0
                and 2 * N % m == 0
                and (decode or mamba_chunk_len(x.shape[1]) % m == 0)):
            return _ssd_heads(cell, x, state, decode, i)
    return run_local(run, cell, x, state)


class _MambaHeads:
    """Heads [j·H/n, (j+1)·H/n) of a Mamba2 cell on plain tensors, ``w`` its
    whole weights: ``ssm.Mamba2``'s prefill and step on this device's heads,
    the output a partial sum over ``group`` (the out-projection's rows).
    The B and C columns of the in-projection and the rows of the chunks'
    C·Bᵀ are split over the group too and gathered (what no head owns)."""

    forward = Mamba2.forward
    decode = Mamba2.decode
    _conv = Mamba2._conv
    _discretize = Mamba2._discretize
    _gate_out = Mamba2._gate_out

    def __init__(self, cell, w, j: int, n: int, group):
        d_in, H, P, N = mamba_dims(cell.cfg)
        self.cfg, self.j, self.n, self.group = cell.cfg, j, n, group
        self.d, self.h, self.P, self.N, self.d_in = d_in // n, H // n, P, N, d_in
        d, h, bc = self.d, self.h, 2 * N // n
        cols = torch.cat([torch.arange(j * d, (j + 1) * d), torch.arange(d_in + j * d,
                                                                        d_in + (j + 1) * d),
                          torch.arange(2 * d_in + 2 * N + j * h, 2 * d_in + 2 * N + (j + 1) * h)])
        dev = w["in_proj"].device
        self.w_own = w["in_proj"].index_select(1, cols.to(dev))
        self.w_bc = w["in_proj"][:, 2 * d_in + j * bc:2 * d_in + (j + 1) * bc]
        self.conv_w = torch.cat([w["conv_w"][:, j * d:(j + 1) * d], w["conv_w"][:, d_in:]], 1)
        self.A_log, self.dt_bias, self.D = (w[k][j * h:(j + 1) * h]
                                            for k in ("A_log", "dt_bias", "D"))
        self.out_proj = w["out_proj"][j * d:(j + 1) * d]

    def dims(self):
        return self.d, self.h, self.P, self.N

    def zero_state(self, batch: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        return {"ssm": torch.zeros(batch, self.h, self.P, self.N, **f32),
                "conv": torch.zeros(batch, CONV_K - 1, self.d + 2 * self.N, **f32)}

    def _split_proj(self, x):
        z, xs, dt = (x @ self.w_own).split([self.d, self.d, self.h], dim=-1)
        return z, torch.cat([xs, _Gather.apply(x @ self.w_bc, -1, self.group)], -1), dt

    def _cb(self, Cc, Bc):
        rows = Cc.shape[2] // self.n
        own = torch.einsum("bcin,bcjn->bcij", Cc.narrow(2, self.j * rows, rows), Bc)
        return _Gather.apply(own, 2, self.group)

    def own_conv(self, conv):
        """A whole conv context [B, K − 1, d_in + 2N] → this block's columns."""
        return torch.cat([conv[..., self.j * self.d:(self.j + 1) * self.d],
                          conv[..., self.d_in:]], -1)

    def whole_conv(self, conv):
        """This block's conv context → the whole one (gathered, no gradient)."""
        return torch.cat([_gathered(conv[..., :self.d], conv.dim() - 1, self.group),
                          conv[..., self.d:]], -1)


def _ssd_heads(cell, x, state, decode: bool, ax: int):
    """:func:`_ssd` with the heads split over mesh dim ``ax``: x's batch
    shards kept, the weights gathered whole and each device's heads taken
    (every gradient that device's share, summed over the batch shards and
    ``ax``), the state's heads in the cache's split; the output a partial
    sum over ``ax``, the new state's heads split there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    batch = [i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == 0]
    xp = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    hp = [Shard(1) if i == ax else p for i, p in enumerate(xp)]
    summed = [Partial() if i in batch or i == ax else Replicate() for i in range(mesh.ndim)]
    xl = x.redistribute(mesh, xp).to_local(
        grad_placements=[Partial() if i == ax else p for i, p in enumerate(xp)])
    w = {name: p.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=summed)
         for name, p in cell.named_parameters()}
    view = _MambaHeads(cell, w, mesh.get_local_rank(ax), mesh.size(ax), mesh.get_group(ax))
    st = None if state is None else {
        "ssm": state["ssm"].redistribute(mesh, hp).to_local(),
        "conv": view.own_conv(state["conv"].redistribute(mesh, xp).to_local())}
    y, new = view.decode(xl, st) if decode else view.forward(xl, st)
    return (DTensor.from_local(y, mesh, [Partial() if i == ax else p for i, p in enumerate(xp)],
                               run_check=False),
            {"ssm": DTensor.from_local(new["ssm"], mesh, hp, run_check=False),
             "conv": DTensor.from_local(view.whole_conv(new["conv"]), mesh, xp,
                                        run_check=False)})


def sharded(kernels: Kernels, rules: Rules) -> Kernels:
    """``kernels`` for a model whose tensors are DTensors laid out under
    ``rules`` (the family's :func:`rules_for`): each kernel runs on every
    device's block under ``local_map`` (a plain tensor passes straight
    through), ``constrain`` and ``layout`` lay activations out at
    ``repro``'s sites, and the other fields take DTensors (module
    docstring). What each kernel takes: RMSNorm any layout but a sharded
    normalized dim; flash attention and the mLSTM shards of batch or heads
    (common to all their inputs and dividing the heads), flash attention
    also q's rows where the heads do not divide an axis of the rules'
    "feat" (k and v whole, each device's rows from its ``q_start``), every
    other shard gathered first. The products, the decode attention and the
    Mamba2 cell split work over the "feat" axes where no layout does. The launches inside see only local tensors, so on a
    card they are the CUDA kernels on each block."""
    return Kernels(
        rmsnorm=_sharded_rmsnorm(kernels.rmsnorm),
        attention=_sharded_attention(kernels.attention, rules["feat"]),
        mlstm=_sharded_mlstm(kernels.mlstm),
        constrain=make_constrain(rules),
        layout=lambda x, *logical: constrain(x, rules, *logical),
        matmul=lambda x, w: _matmul(x, w, rules["feat"]), heads=_heads, embed=_embed,
        new_cache=lambda shapes, like, logical, make=torch.zeros: _new_cache(
            shapes, like, logical, rules, make),
        write_prefix=_write_prefix, write_at=_write_at, cross_entropy=_cross_entropy,
        local=run_local, experts=_experts,
        decode_attention=lambda *a: _decode_attention(*a, free_axes=rules["feat"]),
        ssd=lambda cell, x, state=None, decode=False: _ssd(cell, x, state, decode, rules))
