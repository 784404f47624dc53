"""How the port's tests carry inputs across the two packages.

Graphs and cost models cross as plain data (``graph_from_description``,
``cost_from_scalars``), so no object of one package reaches the other. The
reference's CSR oracle ``repro/kernels/partition_sweep/ref.py`` cannot be
imported the normal way (its package ``__init__`` pulls in the Pallas
wrapper), so :func:`load_ref_oracle` loads it by file path.

Training's tests carry ``repro``'s parameter tree across as numpy and map
each of the port's parameters back to the elements of ``repro``'s
gradient tree (:func:`leaf_index`); the tolerance of a gradient leaf is
counted in :func:`grad_sites`.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core
from repro.core.cost import cost_scalars as ref_cost_scalars

from repro_torch.core.cost import cost_from_scalars
from repro_torch.core.graph import graph_from_description


def load_ref_oracle():
    path = Path(repro.core.__file__).parents[1] / "kernels" / "partition_sweep" / "ref.py"
    spec = importlib.util.spec_from_file_location(
        "repro.kernels.partition_sweep.ref", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "repro.kernels.partition_sweep"
    spec.loader.exec_module(mod)
    return mod


def port_cost(cm):
    """The reference's cost model as the port's, name included."""
    return cost_from_scalars(ref_cost_scalars(cm), name=cm.name)


def port_of(g, cm):
    """(the port's copy of graph ``g``, of cost model ``cm``)."""
    packets = [dict(name=p.name, nbytes=p.nbytes, c0_weight=p.c0_weight,
                    keep=p.keep, external=p.external) for p in g.packets.values()]
    tasks = [dict(name=t.name, reads=t.reads, writes=t.writes, cost=t.cost)
             for t in g.tasks]
    return graph_from_description(packets, tasks), port_cost(cm)


def port_placement_spec(spec):
    """The reference's ``PlacementSpec`` as the port's: the same nodes (each
    node cost model carried by ``port_cost``, one port model per reference
    model), links, Q and memory scales."""
    from repro_torch.core import placement as P

    costs = {}

    def cost_of(cm):
        if cm is None:
            return None
        return costs.setdefault(id(cm), port_cost(cm))

    nodes = tuple(P.NodeSpec(q_max=nd.q_max, memory_bytes=nd.memory_bytes,
                             cost=cost_of(nd.cost), compute_scale=nd.compute_scale,
                             name=nd.name) for nd in spec.nodes)
    links = tuple(P.LinkModel(bandwidth_mbps=lk.bandwidth_mbps,
                              energy_per_byte=lk.energy_per_byte,
                              init_energy=lk.init_energy, rx_fraction=lk.rx_fraction,
                              init_s=lk.init_s, name=lk.name) for lk in spec.links)
    return P.PlacementSpec(nodes=nodes, links=links, q_scales=spec.q_scales,
                           memory_scales=spec.memory_scales)


# -- training: the loss and its gradients against ``repro``'s ---------------------------
#
# Tolerance of a gradient leaf: n·U·max|reference leaf|, U = 2^-9, the budget
# per bf16 rounding site of ``tests/test_torch_serve.py``. n = 2·n_fwd + 1 + r:
# n_fwd the forward sites up to the logits (the counts of the serving tests,
# :func:`forward_sites`); the backward mirrors each of them, since the
# cotangent through a bf16 value is itself bf16; the leaf's own
# weight-gradient product rounds once more; and r counts the bf16 additions
# of a weight's gradients beyond its first use, which autograd makes on the
# bf16 parameter where ``repro`` adds float32 casts: the tied head (1), a moe
# router (1: the load-balance loss reads the router probabilities computed
# again), zamba2's shared block (one per group after the first) and an embedding
# row (one per repeat of its token in the batch; XLA's scatter-add also
# adds in bf16, in another order). The CE is float32 from bf16 logits: it
# moves by at most twice their largest move, 2·n_fwd·U·max|logits|; moe's
# loss adds 0.01·aux, held to n_fwd·U of it.

U = 2.0 ** -9


def forward_sites(cfg) -> int:
    """bf16 rounding sites from the tokens to the logits: a self layer 21
    (attention with QKV bias 12, SwiGLU 5, two norms, two residual adds), a
    moe layer 24, a vlm cross layer 15, a whisper encoder layer 22 and
    decoder layer 36, the embedding, final norm and head 4
    (``tests/test_torch_zoo_models.py``); an mLSTM block 14, an sLSTM block
    12, plus 2 (``tests/test_torch_xlstm.py``); a Mamba2 block 17 and a
    shared-block application 16, plus 2 (``tests/test_torch_hybrid.py``)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        n_s = L // cfg.slstm_every
        return 14 * (L - n_s) + 12 * n_s + 2
    if cfg.family == "hybrid":
        return 17 * L + 16 * (L // cfg.attn_every) + 2
    if cfg.family == "encdec":
        return 22 * cfg.n_encoder_layers + 36 * L + 4
    if cfg.family == "vlm":
        n_cross = L // cfg.cross_attn_every
        return 21 * (L - n_cross) + 15 * n_cross + 4
    return (24 if cfg.family == "moe" else 21) * L + 4


def grad_sites(cfg, tokens) -> int:
    """n of a gradient leaf's tolerance (see above), for a batch of
    ``tokens``."""
    reuse = int(np.bincount(np.asarray(tokens).ravel()).max()) - 1
    if cfg.tie_embeddings or cfg.family == "moe":
        reuse += 1
    if cfg.family == "hybrid":
        reuse += cfg.n_layers // cfg.attn_every - 1
    return 2 * forward_sites(cfg) + 1 + reuse


def leaf_index(cfg, tree):
    """{the port's parameter name: int64 indices of its elements in the
    concatenation of ``tree``'s flattened leaves (``jax.tree.leaves``
    order)}: the port's model is built from a tree of the same structure
    whose values are those indices, exact in its float32 masters."""
    from repro_torch.models import api

    leaves, treedef = jax.tree.flatten(tree)
    ids, off = [], 0
    for leaf in leaves:
        n = int(np.prod(np.shape(leaf)))
        ids.append(np.arange(off, off + n, dtype=np.float32).reshape(np.shape(leaf)))
        off += n
    assert off < 2 ** 24, "indices must be exact in float32"
    _, masters = api.trainable_from_numpy(cfg, jax.tree.unflatten(treedef, ids), "cpu")
    index = {k: v.numpy().astype(np.int64).ravel() for k, v in masters.items()}
    assert np.array_equal(np.sort(np.concatenate(list(index.values()))), np.arange(off))
    return index


def flat_leaves(tree):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in jax.tree.leaves(tree)])


def grad_errors(model, index, want_flat, sites):
    """{name: (max |Δ|, tolerance)} of each parameter's float32 gradient
    against the reference's gradient at its elements."""
    out = {}
    for name, p in model.named_parameters():
        want = want_flat[index[name]]
        got = p.grad.to(torch.float32).numpy().ravel()
        out[name] = (float(np.abs(got - want).max()), sites * U * float(np.abs(want).max()))
    return out


@contextlib.contextmanager
def logits_seen():
    """A list that receives max |logits| of every cross-entropy the port's
    losses take inside the block (the plain bundles' ``cross_entropy`` calls
    ``common.softmax_cross_entropy``)."""
    from repro_torch.models import common

    seen = []
    plain = common.softmax_cross_entropy

    def recorded(logits, labels):
        seen.append(float(logits.detach().abs().max()))
        return plain(logits, labels)

    common.softmax_cross_entropy = recorded
    try:
        yield seen
    finally:
        common.softmax_cross_entropy = plain


def three_steps_against_reference(make_step):
    """Three train steps of tinyllama-1.1b's smoke config, b2 × 16, lr 1e-3
    warming up over 20 steps, as ``repro``'s train CLI runs them, through
    ``make_step(cfg, adamw_cfg) -> step(model, state, batch) -> loss`` on
    the CPU, held to ``repro``'s jitted ``api.loss`` + ``adamw_update``
    from the same parameters (the tolerances of ``tests/test_torch_train.py``'s
    module docstring)."""
    import jax.numpy as jnp

    from repro.configs import SMOKE_CONFIGS as REF_SMOKE
    from repro.models import api as ref_api
    from repro.optim import adamw as ref_adamw

    from repro_torch.configs import SMOKE_CONFIGS
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticData
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import api
    from repro_torch.optim import adamw

    arch = "tinyllama-1.1b"
    rcfg, cfg = REF_SMOKE[arch], SMOKE_CONFIGS[arch]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(0), max_seq=16)
    tree = jax.tree.map(np.asarray, params)
    kw = dict(lr=1e-3, warmup_steps=20)
    rcfg_adamw, cfg_adamw = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)

    @jax.jit
    def ref_step(p, o, tokens, labels):
        b = {"tokens": tokens, "labels": labels}
        (loss, _), g = jax.value_and_grad(lambda q: ref_api.loss(rcfg, q, b, remat=True),
                                          has_aux=True)(p)
        p, o, stats = ref_adamw.adamw_update(rcfg_adamw, p, g, o)
        return p, o, loss, g, stats["lr"]

    rp = jax.tree.map(jnp.asarray, tree)
    ro = ref_adamw.adamw_init(rp)
    model, masters = api.trainable_from_numpy(cfg, tree, "cpu")
    state = {"params": masters, "opt_state": adamw.adamw_init(masters)}
    index = leaf_index(cfg, tree)
    data = SyntheticData(SyntheticConfig(cfg.vocab, 16, 2, seed=0))
    step = make_step(cfg, cfg_adamw)
    moved = 0.0
    for s in range(3):
        b = data.batch(s)
        rp, ro, rloss, rgrad, lr = ref_step(rp, ro, jnp.asarray(b["tokens"]),
                                            jnp.asarray(b["labels"]))
        with logits_seen() as seen:
            loss = float(step(model, state, batch_tensors(cfg, b, "cpu")))
        assert abs(loss - float(rloss)) <= 2 * forward_sites(cfg) * U * seen[0], s
        moved += float(lr)
        want = flat_leaves(rp)
        for name, m in state["params"].items():
            got = m.numpy().ravel()
            assert np.abs(got - want[index[name]]).max() <= 2.01 * moved, (s, name)
            assert torch.equal(model.get_parameter(name).detach(), m.to(
                model.get_parameter(name).dtype))
        if s == 0:
            g = flat_leaves(rgrad)
            tol_sites = grad_sites(cfg, b["tokens"])
            for name, m in state["params"].items():
                gi = g[index[name]]
                firm = np.abs(gi) > tol_sites * U * np.abs(gi).max()
                d = np.abs(m.numpy().ravel() - want[index[name]])
                lim = float(lr) * 2.0 ** -7 + 2 * np.spacing(np.abs(want[index[name]]))
                assert np.all(d[firm] <= lim[firm]), name
                assert firm.any(), name


def _write(dst, src) -> None:
    """What a replay does to the graph's outputs: new values, same buffers."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif dst is not None:
        dst.copy_(src)


def eager_record(step, cap, dev):
    """``launch/serve.py::_record`` without a card: the warm-up runs ``step``
    on the static inputs and is the result; the "graph" reruns it eagerly
    into the buffers the warm-up's outputs shaped (a capture executes
    nothing), as a graph's replay writes into its own."""
    from repro_torch.launch.serve import _map

    assert dev == torch.device("cpu")
    out = step(cap.inputs)
    cap.outputs = _map(torch.clone, out)
    cap.replay = lambda: _write(cap.outputs, step(cap.inputs))
    return out


@pytest.fixture
def eager_capture(monkeypatch):
    """Every capture of the test made eager (:func:`eager_record`)."""
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "_record", eager_record)
