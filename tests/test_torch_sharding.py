"""The port's sharding against ``repro``'s (``models/sharding.py``,
``launch/{mesh,steps,roofline}.py``), all on the CPU.

* the resolver: the port's ``logical_to_spec`` equals ``repro``'s on
  ``AbstractMesh`` 16×16 and 2×16×16 for every leaf of the parameters,
  caches, inputs and logits of all ten architectures × ``SHAPES``, and on
  ``tests/test_sharding_rules.py``'s cases; placements and each device's
  block shape against ``NamedSharding(...).shard_shape``;
* the port's logical tables (``api.param_logical``, ``api.cache_logical``)
  against ``repro``'s trees at smoke size and full width, leaf for leaf
  (a stacked leaf's "layers" axes dropped);
* the collectives the counter sees against ``CommDebugMode``'s, and the
  kernels a sharded step calls against the unsharded step's;
* per device against ``repro`` at smoke size, B 8 × S 32 on a (2, 4)
  ("data", "model") mesh: ``repro``'s compiled HLO on eight forced host
  devices (``tests/sharded_referee.py``, one subprocess) against the port's
  count on a (2, 4) ``fake`` mesh. The FLOPs are equal up to the per-device
  share of ``test_torch_dryrun.py::extra_terms`` (the one-card differences)
  and the terms itemized in :func:`mesh_terms`; each device's parameter,
  cache and input blocks are exactly ``repro``'s shard shapes; each
  collective kind of ``repro``'s HLO is in the count or in
  :data:`KINDS_NOT_EMITTED` with its reason; on the moe cells whose tokens
  "model" splits, the collective bytes that grow with the experts' slots
  are, in both packages, the slot buffers :data:`SLOT_BUFFERS` itemizes;
* the production mesh and ``train --production-mesh`` refuse any other
  process count, naming it.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.sharding import logical_to_spec as ref_logical_to_spec
from repro.models.sharding import rules_for as ref_rules_for

from test_torch_dryrun import extra_terms

from repro_torch.configs import ALL_ARCHS, SMOKE_CONFIGS, get_config
from repro_torch.kernels.mlstm_chunk.ops import work as mlstm_work
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import build_cell
from repro_torch.models import api
from repro_torch.models.sharding import (logical_to_spec, placements, rules_for, shard_shape,
                                         shardings_for_tree)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
B, S = 8, 32
# {cell: (arch, step kind, B, mesh (data, model), smoke config fields replaced)}, all at
# S 32: tinyllama-1.1b and xlstm-1.3b at B 8 split everything eight ways; the others
# leave "model" free of the batch (B 2 for the ssm and hybrid tables), or give it
# experts to split (moe) or heads it does not divide (whisper-large-v3's 4 on a (1, 8)
# mesh, deepseek-coder-33b's smoke config with 6 heads of 16 on (2, 4))
REFEREE = {
    **{f"{a}/{k}": (a, k, B, (2, 4), {}) for a in ("tinyllama-1.1b", "xlstm-1.3b")
       for k in ("train", "prefill", "decode")},
    **{f"{a}/{k}": (a, k, B, (2, 4), {}) for a in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
       for k in ("train", "prefill", "decode")},
    **{f"xlstm-1.3b/{k}@b2": ("xlstm-1.3b", k, 2, (2, 4), {}) for k in ("prefill", "decode")},
    **{f"zamba2-7b/{k}@b2": ("zamba2-7b", k, 2, (2, 4), {})
       for k in ("train", "prefill", "decode")},
    **{f"whisper-large-v3/{k}@1x8": ("whisper-large-v3", k, B, (1, 8), {})
       for k in ("train", "prefill", "decode")},
    **{f"deepseek-coder-33b/{k}@6heads": ("deepseek-coder-33b", k, B, (2, 4),
                                          {"n_heads": 6, "head_dim": 16})
       for k in ("train", "prefill", "decode")},
    # dims "model" does not divide: whisper's 1500 audio frames on 16 (here 12
    # on 8; its decode: the train and prefill steps of repro pad the frames,
    # ROADMAP queue 3), granite's 49155-entry vocabulary on 16 (here 250 on 4)
    "whisper-large-v3/decode@1x8-12frames": ("whisper-large-v3", "decode", B, (1, 8),
                                             {"n_audio_frames": 12}),
    **{f"granite-moe-1b-a400m/{k}@vocab250": ("granite-moe-1b-a400m", k, B, (2, 4),
                                              {"vocab": 250})
       for k in ("prefill", "decode")},
}
REFEREE_CELLS = list(REFEREE)
# the moe cells whose tokens are split over "model": each is also compiled by
# repro with twice its capacity factor, so that the collective bytes which
# grow with the slots (the exchange of the experts' [E, C] slot rows) can be
# told from the rest
CAPACITY_X2 = {n: f"{n}#capacity-x2" for n, (a, k, _, _, r) in REFEREE.items()
               if a in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
               and k in ("train", "prefill") and not r}


def abstract_mesh(shape, names):
    try:
        return AbstractMesh(shape, names)
    except TypeError:  # older jax: ((name, size), ...)
        return AbstractMesh(tuple(zip(names, shape)))


def ref_spec(logical, family, amesh, shape):
    return tuple(ref_logical_to_spec(tuple(logical), ref_rules_for(family), amesh,
                                     shape=tuple(shape)))


def trimmed(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def flat_logical(tree, prefix=()):
    """{key path: logical tuple} of a logical tree (dicts nest; None kept)."""
    if tree is None or isinstance(tree, tuple):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat_logical(v, prefix + (k,)))
    return out


def flat_shapes(tree, prefix=()):
    """{key path: shape} of a tree of arrays, ShapeDtypeStructs or the
    port's (shape, dtype) pairs."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape) if hasattr(tree, "shape") else tuple(tree[0])}


def repro_path(cfg, name):
    """(``repro``'s key path of the leaf a port parameter comes from, how
    many stacked axes that leaf has in front) — the carrying of
    ``api.params_from_numpy``."""
    parts = name.split(".")
    fam = cfg.family
    if parts[0] == "layers":
        rest = parts[2:]
        if fam == "vlm":
            return ("groups", "self", *rest), 2
        if fam == "moe" and rest[0] == "mlp":
            rest = ["moe", *rest[1:]]
        return ("layers", *rest), 1
    if parts[0] == "cross":
        return ("groups", "cross", *parts[2:]), 1
    if parts[0] in ("enc", "dec"):
        rest = ["self" if parts[2] == "self_attn" else parts[2], *parts[3:]]
        return (parts[0], *rest), 1
    if fam == "ssm" and parts[0] == "groups":
        if parts[2] == "m":
            return ("groups", "m", *parts[4:]), 2
        return ("groups", parts[2], *parts[3:]), 1
    if fam == "hybrid" and parts[0] == "groups":
        return ("groups", "mamba", *parts[3:]), 2
    if parts[0] == "tail":
        return ("tail", *parts[2:]), 1
    if parts[0] == "shared" and parts[1] == "attn":
        return ("shared", *parts[2:]), 0
    return tuple(parts), 0


def _ref_params(cfg, max_seq):
    tree, logical = ref_api.init_params(cfg, None, max_seq=max_seq)
    return flat_shapes(jax.tree.map(lambda a: a, tree)), flat_logical(logical)


# -- the resolver -----------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_resolver_and_tables_equal_repros_on_every_leaf(arch, mesh_name):
    """Every leaf of the parameters, caches, inputs and logits of every
    shape: the port's resolver on ``repro``'s annotation equals ``repro``'s,
    and the port's own tables (per-layer parameters, caches) resolve to
    the same entries."""
    shape_, names = MESHES[mesh_name]
    amesh, mesh = abstract_mesh(shape_, names), (names, shape_)
    cfg, pcfg = ref_get_config(arch), get_config(arch)
    rules, fam = rules_for(pcfg.family), cfg.family
    port_tables = api.param_logical(pcfg)
    checked = 0
    for shape_name, shape in SHAPES.items():
        b, s = shape.global_batch, shape.seq_len
        shapes, logical = _ref_params(cfg, s)
        for path, lg in logical.items():
            assert logical_to_spec(lg, rules, mesh, shapes[path]) == ref_spec(
                lg, fam, amesh, shapes[path]), (path, lg)
        model = api.init_params(pcfg, None, "meta", max_seq=s)
        for name, p in model.named_parameters():
            path, lead = repro_path(pcfg, name)
            want = ref_spec(logical[path], fam, amesh, shapes[path])
            got = logical_to_spec(port_tables[name], rules, mesh, tuple(p.shape))
            assert got == trimmed(want[lead:]), (name, got, want)
            checked += 1
        ref_cache, ref_cache_l = ref_api.cache_shape(cfg, b, s)
        cache_l = flat_logical(api.cache_logical(pcfg, b, s))
        cache_s = flat_shapes(api.cache_shape(pcfg, b, s))
        assert cache_l == flat_logical(ref_cache_l)
        assert cache_s == flat_shapes(ref_cache)
        for path, lg in cache_l.items():
            if lg is not None:
                assert logical_to_spec(lg, rules, mesh, cache_s[path]) == ref_spec(
                    lg, fam, amesh, cache_s[path]), path
        inputs = flat_shapes(ref_api.input_specs(cfg, REF_SHAPES[shape_name]))
        for path, shp in inputs.items():
            lg = ("batch",) + (None,) * (len(shp) - 1) if shp else ()
            assert logical_to_spec(lg, rules, mesh, shp) == ref_spec(lg, fam, amesh, shp), path
        logits = (b, 1, cfg.vocab)
        lg = ("batch", None, "vocab")
        assert logical_to_spec(lg, rules, mesh, logits) == ref_spec(lg, fam, amesh, logits)
    assert checked


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_logical_tables_equal_repros_trees(arch, size):
    """``api.param_logical``: each port parameter carries the logical axes
    of the ``repro`` leaf it comes from (``init_params(cfg, None)``'s tree)
    with the leaf's stacked "layers" axes dropped, and every ``repro`` leaf
    is some port parameter's; ``api.cache_logical`` is ``cache_shape``'s
    logical tree, leaf for leaf."""
    cfg = SMOKE_CONFIGS[arch] if size == "smoke" else get_config(arch)
    rcfg = REF_SMOKE[arch] if size == "smoke" else ref_get_config(arch)
    _, logical = _ref_params(rcfg, 64)
    seen = set()
    for name, lg in api.param_logical(cfg).items():
        path, lead = repro_path(cfg, name)
        assert logical[path][:lead] == ("layers",) * lead, (name, logical[path])
        assert lg == tuple(logical[path][lead:]), (name, lg, logical[path])
        seen.add(path)
    assert seen == set(logical)
    _, ref_cache_l = ref_api.cache_shape(rcfg, 4, 64)
    assert flat_logical(api.cache_logical(cfg, 4, 64)) == flat_logical(ref_cache_l)


RESOLVER_CASES = {
    # tests/test_sharding_rules.py's cases, on the port's resolver
    "dense_train_batch": ("dense", "16x16", ("batch", "act_seq", None), (256, 4096, 1024)),
    "no_duplicate_axes_in_one_spec": ("ssm", "16x16", ("batch", "kv_seq"), (128, 32768)),
    "greedy_skips_non_dividing_axis": ("ssm", "pod2x16x16", ("batch",), (128,)),
    "batch_one_replicated": ("ssm", "pod2x16x16", ("batch", "kv_seq"), (1, 524288)),
    "unknown_logical_raises": ("dense", "16x16", ("nope",), (8,)),
    "smoke_mesh_all_replicated": ("dense", "1x1", ("batch", "act_seq", None), (2, 32, 64)),
}


@pytest.mark.parametrize("case", sorted(RESOLVER_CASES))
def test_resolver_invariants(case):
    family, mesh_name, logical, shape = RESOLVER_CASES[case]
    mesh = ((("data", "model"), (1, 1)) if mesh_name == "1x1"
            else (MESHES[mesh_name][1], MESHES[mesh_name][0]))
    rules = rules_for(family)
    if case == "unknown_logical_raises":
        with pytest.raises(KeyError):
            logical_to_spec(logical, rules, mesh, shape)
        return
    spec = logical_to_spec(logical, rules, mesh, shape)
    used = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
    assert len(used) == len(set(used))
    if case == "dense_train_batch":
        assert spec == ("data", "model")
    if case == "greedy_skips_non_dividing_axis":
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        assert "data" in axes and "pod" in axes and "model" not in axes
    if case == "batch_one_replicated":
        assert spec[0] is None and spec[1] is not None
    if case == "smoke_mesh_all_replicated":
        assert shard_shape(shape, spec, mesh) == shape
    jspec = ref_spec(logical, family, abstract_mesh(mesh[1], mesh[0]), shape)
    assert spec == jspec


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b", "zamba2-7b", "whisper-large-v3"])
def test_placements_and_block_shapes_against_named_sharding(arch, mesh_name):
    """Each parameter and cache leaf of a decode_32k and a train_4k cell:
    the port's block shape equals ``NamedSharding(mesh, spec).shard_shape``,
    and its placements shard exactly the dims the spec names, on the mesh
    dims of those axes."""
    from torch.distributed.tensor import Shard

    shape_, names = MESHES[mesh_name]
    amesh, mesh = abstract_mesh(shape_, names), (names, shape_)
    pcfg = get_config(arch)
    rules = rules_for(pcfg.family)
    for shape in (SHAPES["decode_32k"], SHAPES["train_4k"]):
        model = api.init_params(pcfg, None, "meta", max_seq=shape.seq_len)
        leaves = {n: (lg, tuple(p.shape)) for (n, p), lg in zip(
            model.named_parameters(), api.param_logical(pcfg, model).values())}
        cache_l = flat_logical(api.cache_logical(pcfg, shape.global_batch, shape.seq_len))
        cache_s = flat_shapes(api.cache_shape(pcfg, shape.global_batch, shape.seq_len))
        leaves.update({p: (cache_l[p], cache_s[p]) for p in cache_l if cache_l[p]})
        for key, (lg, shp) in leaves.items():
            spec = logical_to_spec(lg, rules, mesh, shp)
            want = NamedSharding(amesh, P(*spec)).shard_shape(shp)
            assert shard_shape(shp, spec, mesh) == tuple(want), key
            pl = placements(spec, mesh)
            for i, axis in enumerate(names):
                dims = [d for d, e in enumerate(spec)
                        if e is not None and axis in (e if isinstance(e, tuple) else (e,))]
                assert (pl[i] == Shard(dims[0])) if dims else pl[i].is_replicate(), (key, i)
        tree = api.cache_shape(pcfg, shape.global_batch, shape.seq_len)
        by_leaf = shardings_for_tree(api.cache_logical(pcfg, shape.global_batch, shape.seq_len),
                                     tree, rules, mesh)
        for path, lg in cache_l.items():
            node = by_leaf
            for k in path:
                node = node[k]
            if lg is None:
                assert node is None
            else:
                assert node == placements(logical_to_spec(lg, rules, mesh, cache_s[path]),
                                          mesh), path


# -- the count on a fake mesh -----------------------------------------------------------


@pytest.fixture(scope="module")
def fake_mesh():
    """The (2, 4) ("data", "model") count mesh; the fake group is taken down
    after the module."""
    yield mesh_mod.count_mesh((2, 4), ("data", "model"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _shape(kind):
    return ShapeConfig(f"s_{kind}", S, B, kind)


COMM_CELLS = [(a, k) for a in ("tinyllama-1.1b", "xlstm-1.3b", "granite-moe-1b-a400m",
                               "whisper-large-v3", "llama-3.2-vision-11b")
              for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", COMM_CELLS)
def test_counted_collectives_equal_comm_debug_modes(fake_mesh, arch, kind):
    """The counter's collectives by kind against ``CommDebugMode`` over the
    same count, and every collective's bytes by ``repro``'s convention; the
    kernels the sharded step calls are the unsharded step's."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = SMOKE_CONFIGS[arch]
    cell = build_cell(cfg, _shape(kind), "meta", mesh=fake_mesh)
    with CommDebugMode() as comm:
        _, stats = cell.count()
    kinds = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce", "shard_dim_alltoall": "all-to-all",
             "all_to_all_single": "all-to-all"}
    seen = {}
    for op, n in comm.get_comm_counts().items():
        kind_ = kinds[str(op).split(".")[-1]]
        seen[kind_] = seen.get(kind_, 0) + n
    assert seen == stats.coll_count_by_kind and seen
    assert all(b > 0 for b in stats.coll_bytes_by_kind.values())
    one = build_cell(cfg, _shape(kind), "meta").count()[1]
    assert stats.kernel_calls == one.kernel_calls


def test_collective_bytes_follow_repros_convention(fake_mesh):
    """A weight all-gathered over "model" (4) counts its output ÷ 4, i.e.
    one device's block; a reduce-scatter its output × 4."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.roofline import count_step

    w = DTensor.from_local(torch.empty(8, 16, device="meta"), fake_mesh,
                           [Replicate(), Shard(1)], run_check=False)
    p = DTensor.from_local(torch.empty(8, 64, device="meta"), fake_mesh,
                           [Replicate(), Partial()], run_check=False)
    _, st = count_step(lambda a, b: (a.redistribute(fake_mesh, [Replicate(), Replicate()]),
                                     b.redistribute(fake_mesh, [Replicate(), Shard(1)])), w, p)
    assert st.coll_count_by_kind == {"all-gather": 1, "reduce-scatter": 1}
    assert st.coll_bytes_by_kind["all-gather"] == 8 * 16 * 4
    assert st.coll_bytes_by_kind["reduce-scatter"] == 8 * 16 * 4 * 4


# -- per device against repro -----------------------------------------------------------

# (arch or "*", step kind or "*", collective kind): why the port's count has
# none of a kind that repro's partitioned HLO has
KINDS_NOT_EMITTED = {
    ("*", "*", "collective-permute"):
        "XLA's shifts along a sharded dim (the decode one-hot update's halo, the mLSTM "
        "chunk's carried state); DTensor moves data only by all-gather, reduce-scatter, "
        "all-to-all and all-reduce",
    ("xlstm-1.3b", "train", "all-to-all"):
        "XLA re-lays one mLSTM projection's gradient by an all-to-all; DTensor reduces it "
        "(reduce-scatter, all-reduce) where it was made",
    **{(a, k, "all-reduce"):
       "XLA brings the experts' outputs back to their tokens by the combine einsum's sum "
       "over the model-split experts (an all-reduce); the port by an all-to-all of the "
       "experts' rows (sharding._expert_parallel)"
       for a in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b") for k in ("prefill",)},
    ("whisper-large-v3", "prefill", "all-reduce"):
        "XLA sums the encoder's output projection over its model-split features (partial "
        "products, an all-reduce); the port gathers the weight and each device takes its "
        "rows (sharding._matmul)",
    **{(a, k, "all-to-all"):
       "XLA moves attention's activations between the projections' feature split and the "
       "query rows' sequence split by all-to-all where the heads do not divide 'model'; "
       "the port gathers the split it leaves (all-gather)"
       for a, k in (("whisper-large-v3", "train"), ("whisper-large-v3", "decode"),
                    ("whisper-large-v3", "prefill"), ("deepseek-coder-33b", "train"),
                    ("deepseek-coder-33b", "prefill"))},
    ("xlstm-1.3b", "decode", "all-reduce"):
        "XLA contracts the mLSTM state C along a model-split dim and all-reduces the "
        "product; the port's decode step follows the state's layout, split by the batch "
        "alone where the batch covers the mesh",
}


def not_emitted(arch, kind, coll):
    return any(k in KINDS_NOT_EMITTED for k in ((arch, kind, coll), ("*", kind, coll),
                                                 (arch, "*", coll), ("*", "*", coll)))


def mesh_terms(cfg, kind, mesh_shape=(2, 4), b=B, s=S):
    """{term: (per-device FLOPs, the line)}: what ``repro``'s partitioned
    HLO does beyond 1/n of its one-device HLO on a ``mesh_shape`` ("data",
    "model") mesh of n devices (negative: less)."""
    n_dev = math.prod(mesh_shape)
    terms = {}
    if cfg.family == "ssm" and kind == "train":
        n_s = cfg.n_layers // cfg.slstm_every
        n_m = cfg.n_layers - n_s
        h, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        terms["repro on the mesh: one of the two products of the mLSTM C update's zero "
              "cotangent (d(k), d(v)) is gone"] = (
            -n_m * 2 * b * s * h * hd * hd // n_dev, "repro/models/xlstm.py:165")
    if cfg.family == "ssm" and b % n_dev and kind != "train":
        # the batch leaves "model" free; the mLSTM's heads do not divide it
        n_s = cfg.n_layers // cfg.slstm_every
        n_m = cfg.n_layers - n_s
        h, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        n_batch = math.gcd(b, n_dev)
        if kind == "prefill":
            whole = n_m * mlstm_work(b * h, s, hd, 128, 2).flops
            terms["port: the mLSTM chunk kernel whole on each 'model' device (its heads do not "
                  "divide the axis; repro splits C's key features there)"] = (
                -(whole // n_batch - whole // n_dev), "repro_torch/models/sharding.py")
            terms["repro on the mesh: each chunk's q·kᵀ and n update split by the heads, "
                  "whole on two of the four 'model' devices"] = (
                n_m * 2 * b * s * h * hd * (min(s, 128) + 1) // n_dev,
                "repro/models/xlstm.py:148,168")
        else:
            terms["repro on the mesh: the decode's q·n twice a device"] = (
                n_m * 2 * b * h * hd // n_dev, "repro/models/xlstm.py:200")
    if cfg.family == "hybrid" and b % n_dev and kind == "train":
        d = cfg.d_model
        terms["repro on the mesh: the backward of its remat'd group body does one product "
              "of the shared block's q, k, v size (from the 2d concat) more a device"] = (
            3 * 2 * b * s * 2 * d * d // n_dev, "repro/models/recurrent.py:311")
    if cfg.family == "moe" and kind == "train" and cfg.moe.n_experts == mesh_shape[1]:
        m = cfg.moe
        terms["repro on the mesh: the gate's gradient product over e is a multiply where "
              "each device holds one expert"] = (
            -cfg.n_layers * 2 * b * s * m.top_k * m.n_experts // n_dev,
            "repro/models/moe.py:79")
    return terms


@pytest.fixture(scope="module", autouse=True)
def _referee_process(tmp_path_factory):
    """``repro``'s per-device numbers for :data:`REFEREE_CELLS`, computed in
    one subprocess (XLA_FLAGS must force eight host devices before jax is
    imported) that starts with the module's first test and runs beside it."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    err = tmp_path_factory.mktemp("referee") / "stderr"
    with open(err, "w") as fh:
        cells = [{"name": n, "arch": a, "kind": k, "b": b, "s": S, "mesh": list(m),
                  "replace": r} for n, (a, k, b, m, r) in REFEREE.items()]
        cells += [dict(c, name=CAPACITY_X2[c["name"]], replace={
            "moe.capacity_factor": 2 * REF_SMOKE[c["arch"]].moe.capacity_factor})
            for c in cells if c["name"] in CAPACITY_X2]
        proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "sharded_referee.py"),
                                 json.dumps(cells)], env=env, stdout=subprocess.PIPE,
                                stderr=fh, text=True)
        proc.stderr_path = err
        yield proc
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def referee(_referee_process):
    out, _ = _referee_process.communicate(timeout=300)
    assert _referee_process.returncode == 0, _referee_process.stderr_path.read_text()[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# slot buffers a layer moves over "model" per device, in units of one bf16
# [local groups, E * C, d] buffer, where the tokens are split over "model"
SLOT_BUFFERS = {
    "port": {
        "prefill": (2, "the dispatch and the return all-to-all (sharding._expert_parallel)"),
        "train": (6, "the two all-to-alls in the forward, again in the checkpointed "
                     "block's recompute, and their gradients' two"),
    },
    "repro": {
        "prefill": (2.5, "the dispatch einsum's sum over the sequence-split tokens, an "
                         "all-reduce of the float32 [E, G, C, d] slots (two buffers' "
                         "bytes), and an all-gather of half a buffer for the combine "
                         "(repro/models/moe.py:83,88)"),
        "train": (2.5, "as its prefill: XLA's backward of the dispatch and combine moves "
                       "token rows, not slots"),
    },
}


def slot_buffer_bytes(cfg, b, mesh_shape):
    """One device's bf16 slot buffer of a MoE layer: its batch block's token
    groups × E · C slots × d."""
    from repro_torch.models.moe import GROUP_SIZE, moe_capacity

    group = min(GROUP_SIZE, S)
    groups = b // mesh_shape[0] * S // group
    return groups * cfg.moe.n_experts * moe_capacity(cfg.moe, group) * cfg.d_model * 2


def _dtensor_leaves(tree, prefix=()):
    from repro_torch.models.sharding import is_dtensor

    if isinstance(tree, torch.nn.Module):
        return {(n,): p for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dtensor_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree} if is_dtensor(tree) else {}


@pytest.mark.parametrize("cell_name", REFEREE_CELLS)
def test_per_device_flops_and_blocks_equal_repros(referee, cell_name):
    arch, kind, b, mesh_shape, replace = REFEREE[cell_name]
    cfg = dataclasses.replace(SMOKE_CONFIGS[arch], **replace)
    rcfg = dataclasses.replace(REF_SMOKE[arch], **replace)
    n_dev = math.prod(mesh_shape)
    mesh = mesh_mod.count_mesh(mesh_shape, ("data", "model"))
    cell = build_cell(cfg, ShapeConfig(f"s_{kind}", S, b, kind), "meta", mesh=mesh)
    out, stats = cell.count()
    ref = referee[cell_name]
    if kind != "train":  # the step's outputs laid out as repro's out_shardings
        want = cell.placements["outputs"]
        assert tuple(out[0].placements) == want["logits"]
        for path, t in _dtensor_leaves(out[1]).items():
            node = want["cache"]
            for k in path:
                node = node[k]
            assert list(t.placements) == node, path
    one_card = sum(f for f, _ in extra_terms(cfg, kind, b, S).values())
    assert one_card % n_dev == 0
    terms = mesh_terms(cfg, kind, mesh_shape, b)
    mesh_ = sum(f for f, _ in terms.values())
    assert stats.flops + one_card // n_dev + mesh_ == ref["flops"], (stats.flops, ref["flops"])
    for name, (f, _) in terms.items():  # the control: each term is needed
        assert f and stats.flops + one_card // n_dev + mesh_ - f != ref["flops"], name
    # each device's blocks: exactly repro's shard shapes
    amesh = abstract_mesh(mesh_shape, ("data", "model"))
    shapes, logical = _ref_params(rcfg, S)
    blocks = {}
    for key, t in _dtensor_leaves(cell.args[0]).items():
        path, lead = repro_path(cfg, key[0])
        spec = P(*ref_spec(logical[path], rcfg.family, amesh, shapes[path]))
        want = NamedSharding(amesh, spec).shard_shape(shapes[path])[lead:]
        assert tuple(t.to_local().shape) == tuple(want), key
        blocks[key] = t
    if kind == "train":  # masters and moments as their parameters
        for part in ("params",):
            for name, t in cell.args[1][part].items():
                assert t.to_local().shape == blocks[(name,)].to_local().shape
        for m in ("m", "v"):
            for name, t in cell.args[1]["opt_state"][m].items():
                assert t.to_local().shape == blocks[(name,)].to_local().shape
        inputs = cell.args[2]
    elif kind == "prefill":
        inputs = cell.args[1]
    else:
        inputs = {"token": cell.args[2]}
        ref_cache, ref_cache_l = ref_api.cache_shape(rcfg, b, S)
        want_l, want_s = flat_logical(ref_cache_l), flat_shapes(ref_cache)
        for path, t in _dtensor_leaves(cell.args[1]).items():
            spec = P(*ref_spec(want_l[path], rcfg.family, amesh, want_s[path]))
            assert tuple(t.to_local().shape) == tuple(
                NamedSharding(amesh, spec).shard_shape(want_s[path])), path
    for path, t in _dtensor_leaves(inputs).items():
        lg = ("batch",) + (None,) * (t.dim() - 1)
        spec = P(*ref_spec(lg, rcfg.family, amesh, tuple(t.shape)))
        assert tuple(t.to_local().shape) == tuple(
            NamedSharding(amesh, spec).shard_shape(tuple(t.shape))), path
    # the count's argument bytes are those blocks' bytes
    from repro_torch.launch.roofline import storage_bytes

    assert stats.argument_bytes == storage_bytes(cell.args)
    for kind_ in ref["coll_count_by_kind"]:
        assert kind_ in stats.coll_count_by_kind or not_emitted(arch, kind, kind_), kind_
    if cell_name in CAPACITY_X2:
        # the bytes that grow with the slots, per device: the port's all-to-alls
        # against repro's HLO, each equal to its itemized count of slot buffers
        # (SLOT_BUFFERS; PERF.md section 4 gives the ratio)
        cfg2 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=2 * cfg.moe.capacity_factor))
        _, stats2 = build_cell(cfg2, ShapeConfig(f"s_{kind}", S, b, kind), "meta",
                               mesh=mesh).count()
        ref2 = referee[CAPACITY_X2[cell_name]]
        grown = slot_buffer_bytes(cfg2, b, mesh_shape) - slot_buffer_bytes(cfg, b, mesh_shape)
        port = {k: stats2.coll_bytes_by_kind.get(k, 0) - stats.coll_bytes_by_kind.get(k, 0)
                for k in set(stats.coll_bytes_by_kind) | set(stats2.coll_bytes_by_kind)}
        assert {k: v for k, v in port.items() if v} == {
            "all-to-all": SLOT_BUFFERS["port"][kind][0] * cfg.n_layers * grown}
        repro = sum(ref2["coll_bytes_by_kind"].values()) - sum(ref["coll_bytes_by_kind"].values())
        assert repro == SLOT_BUFFERS["repro"][kind][0] * cfg.n_layers * grown


def test_per_device_count_is_an_eighth_where_everything_divides(fake_mesh):
    """tinyllama-1.1b's smoke prefill at B 8 × S 32: every product and the
    flash kernel's work split eight ways (the heads over "model")."""
    cfg = SMOKE_CONFIGS["tinyllama-1.1b"]
    one = build_cell(cfg, _shape("prefill"), "meta").count()[1]
    dev = build_cell(cfg, _shape("prefill"), "meta", mesh=fake_mesh).count()[1]
    assert dev.flops * 8 == one.flops
    assert dev.ops["kernel:flash_attention"][1] * 8 == one.ops["kernel:flash_attention"][1]


# -- meshes -----------------------------------------------------------------------------


def test_production_mesh_refuses_another_count():
    with pytest.raises(ValueError, match=r"256 processes, this launch has \d+"):
        mesh_mod.make_production_mesh(False)
    assert mesh_mod.production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))


def test_train_production_mesh_refuses_another_count(tmp_path, monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="512 processes, this launch has 8"):
        train.main(["--production-mesh", "--multi-pod", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized() or torch.distributed.get_backend() == "fake"


def test_count_mesh_grows_its_group_and_keeps_its_meshes():
    """A mesh over the first ranks of a large enough fake group; the group
    is replaced only when a mesh needs more ranks; the same (shape, names)
    gives the same mesh, so counts on two meshes alternate in one group."""
    m = mesh_mod.count_mesh((2, 2), ("data", "model"))
    assert m.size() == 4 and torch.distributed.get_world_size() >= 4
    big = mesh_mod.count_mesh((16, 16), ("data", "model"), world=512)
    assert big.size() == 256 and torch.distributed.get_world_size() >= 256
    pod = mesh_mod.count_mesh((2, 16, 16), ("pod", "data", "model"), world=512)
    assert torch.distributed.get_world_size() == 512
    assert mesh_mod.count_mesh((16, 16), ("data", "model"), world=512) is big
    cfg = SMOKE_CONFIGS["qwen1.5-0.5b"]
    for m in (big, pod, big):
        assert build_cell(cfg, ShapeConfig("d", 64, 512, "decode"), "meta",
                          mesh=m).count()[1].coll_count_by_kind
    torch.distributed.destroy_process_group()


def test_constrain_is_the_identity_off_a_mesh():
    from repro_torch.models.sharding import constrain

    x = torch.randn(2, 3, 4)
    assert constrain(x, rules_for("dense"), "batch", "act_seq", None) is x
    assert math.prod(shard_shape((16, 8), ("data",), (("data",), (4,)))) == 32
    assert re.match(r"Shard\(dim=0\)", repr(placements(("data",), (("data",), (4,)))[0]))


def test_per_device_records_of_looped_cells_are_direct_counts(tmp_path, monkeypatch):
    """A per-device ssm cell (the sLSTM loops over positions on the host) is
    counted directly at its own length, ``--check-fit`` or not: per device
    the step is no quadratic in the length (``launch/dryrun.py``), so no
    fit stands in for the count. Smoke xlstm-1.3b, a 1024-token prefill on
    the fake 16x16 mesh: the record is the direct count, collectives
    included, while the one-card record of the same cell is a fit."""
    from repro_torch.launch import dryrun

    shape = ShapeConfig("prefill_1024", 1024, 2, "prefill")
    cfg = SMOKE_CONFIGS["xlstm-1.3b"]
    assert dryrun.fit_lengths(cfg, shape, check=True, mesh="16x16") is None
    assert dryrun.fit_lengths(cfg, shape) == [256, 384, 512, 640]
    monkeypatch.setattr(dryrun, "get_config", SMOKE_CONFIGS.__getitem__)
    monkeypatch.setattr(dryrun, "SHAPES", {shape.name: shape})
    monkeypatch.setattr(dryrun, "workers", lambda n_tasks: 1)
    try:
        assert dryrun.main(["--arch", "xlstm-1.3b", "--check-fit", "--multi-pod", "single",
                            "--device", "cpu", "--out", str(tmp_path)]) == 0
        direct = dryrun.count_at("xlstm-1.3b", shape.name, 1024, mesh="16x16").sizes
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    rec = json.loads((tmp_path / "xlstm-1.3b_prefill_1024_16x16.json").read_text())
    assert rec["status"] == "ok" and "counted_at" not in rec
    assert rec["cost_analysis"] == {"flops": direct["flops"], "bytes accessed": direct["bytes"]}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] == direct["peak_bytes"]
    assert rec["collective_count_by_kind"] == {
        k.split(":", 1)[1]: v for k, v in direct.items() if k.startswith("coll_count:")}
    assert rec["collective_bytes_total"] == sum(
        v for k, v in direct.items() if k.startswith("coll_bytes:")) > 0
