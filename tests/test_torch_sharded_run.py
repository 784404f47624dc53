"""A real sharded run on the CPU: the port's sharded cells in gloo process
groups (``tests/sharded_gloo_worker.py``), against ``repro`` and against
the port's own unsharded cells.

* four processes on a (2, 2) ("data", "model") mesh, with ``repro``'s
  smoke parameters carried in by ``params_from_numpy``: qwen3-4b's prefill
  of B 4 × 16 tokens and two teacher-forced decode steps, every logit
  within the serving tests' bound of ``repro``'s (n·2^-9·max|logits|, n =
  18·L + 2 bf16 sites, ``tests/test_torch_serve.py``), each cache leaf
  within the same bound of ``repro``'s; tinyllama-1.1b's train step on B 4
  × 16, the loss within 2·n_fwd·2^-9·max|logits| of ``repro``'s CE and
  every gradient leaf within the loss tests' n·2^-9·max|leaf| of
  ``jax.value_and_grad`` of ``repro``'s loss (``helpers_torch``). Controls:
  the logits against ``repro``'s for the tokens shifted by one, and the
  gradients against ``repro``'s for the labels shifted by one, must miss.
  The same for granite-moe-1b-a400m (smoke, 8 experts, two a device): its
  serving within the zoo tests' bound (24·L + 4 sites), its loss and
  gradients within the loss bounds, each with the shifted control. And
  attention on a query sequence shard (3 heads on a 2-way "model", 16 and
  15 positions): the output and the gradients of q, k and v within
  1e-5·max of the plain attention on the whole tensors, causal and not;
  the causal output against the non-causal one as the control. Gloo has every collective
  these steps take (DTensor moves a shard to another dim on a CPU mesh by
  an all-gather and a chunk; the experts' tokens go by gloo's
  all_to_all_single): no cell is left to the fake backend.
* xlstm-1.3b and zamba2-7b (smoke) serving the first 2 rows, which leave
  "model" to the cells (the mLSTM step in the state's split, each device
  its Mamba2 heads): logits and every cache leaf within the serving bound
  of ``repro``'s (n = ``helpers_torch.forward_sites``), with the shifted
  control.
* one process on a (1, 1) mesh: the sharded cells' logits, cache, loss,
  gradients, masters and moments bitwise the unsharded cells'.
* the sharded cells as CUDA graphs on the (2, 2) mesh, the capture made
  eager (``CellSpec.replay``; the DTensor inputs fed into each process's
  blocks): qwen3-4b's and granite-moe's prefill (a replay) and decode steps
  bitwise the eager sharded ones above, and two graphed train steps of
  tinyllama-1.1b and granite-moe bitwise two eager ones (losses, masters,
  m, v); one capture per graphed cell, none eager.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.models import api as ref_api
from repro.models.transformer import lm_forward as ref_lm_forward

from helpers_torch import U, flat_leaves, forward_sites, grad_sites, leaf_index
from test_torch_serve import model_sites
from test_torch_loss import batch_pair, numpy_params
from test_torch_zoo_models import sites

from repro_torch.configs import SMOKE_CONFIGS

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_SEQ, N_DECODE = 4, 16, 32, 2


MOE = "granite-moe-1b-a400m"
RECURRENT = ("xlstm-1.3b", "zamba2-7b")


def _inputs():
    rs = np.random.RandomState(7)
    qcfg, tcfg = REF_SMOKE["qwen3-4b"], REF_SMOKE["tinyllama-1.1b"]
    qp, _ = ref_api.init_params(qcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    tp, _ = ref_api.init_params(tcfg, jax.random.PRNGKey(1), max_seq=S)
    mp, _ = ref_api.init_params(REF_SMOKE[MOE], jax.random.PRNGKey(2), max_seq=MAX_SEQ)
    # the MoE train step on test_torch_loss.py's granite case (B 2 × 16): the
    # B 4 × 16 batch above flips a near-tie route of layer 1 between the port
    # and repro, unsharded as well (ROADMAP, Divergences)
    _, moe_batch = batch_pair(SMOKE_CONFIGS[MOE], False)
    return {"qwen_params": jax.tree.map(np.asarray, qp),
            "tiny_params": jax.tree.map(np.asarray, tp),
            "moe_params": jax.tree.map(np.asarray, mp),
            **{f"{a}_params": jax.tree.map(np.asarray, ref_api.init_params(
                REF_SMOKE[a], jax.random.PRNGKey(3), max_seq=MAX_SEQ)[0]) for a in RECURRENT},
            "moe_train_params": numpy_params(REF_SMOKE[MOE], False),
            "moe_train_tokens": moe_batch["tokens"].numpy(),
            "moe_train_labels": moe_batch["labels"].numpy(),
            "tokens": rs.randint(0, qcfg.vocab, (B, S)).astype(np.int64),
            "decode_tokens": rs.randint(0, qcfg.vocab, (B, N_DECODE)).astype(np.int64),
            "train_tokens": rs.randint(0, tcfg.vocab, (B, S)).astype(np.int64),
            "train_labels": rs.randint(0, tcfg.vocab, (B, S)).astype(np.int64),
            "max_seq": MAX_SEQ}


def _run(tmp, world, rows, cols, inp):
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "sharded_gloo_worker.py"),
                               str(r), str(world), str(rows), str(cols), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    with open(tmp / f"out_{rows}x{cols}.pkl", "rb") as fh:
        return pickle.load(fh)


def _ref_serving(inp, tokens, arch="qwen3-4b", key="qwen_params"):
    cfg = REF_SMOKE[arch]
    params = jax.tree.map(jnp.asarray, inp[key])
    b = tokens.shape[0]
    logits, cache = ref_api.prefill(cfg, params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                    MAX_SEQ)
    out = [np.asarray(logits.astype(jnp.float32))]
    for j in range(N_DECODE):
        tok = jnp.asarray(inp["decode_tokens"][:b, j:j + 1], jnp.int32)
        logits, cache = ref_api.decode_step(cfg, params, cache, tok, jnp.int32(S + j))
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), cache)


def _ref_grads(inp, labels, arch="tinyllama-1.1b", key="tiny", batch_key="train"):
    cfg = REF_SMOKE[arch]
    params = jax.tree.map(jnp.asarray, inp[f"{key}_params"])
    batch = {"tokens": jnp.asarray(inp[f"{batch_key}_tokens"], jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    (loss, ce), grads = jax.value_and_grad(
        lambda p: ref_api.loss(cfg, p, batch, remat=True), has_aux=True)(params)
    logits = ref_lm_forward(cfg, params, batch["tokens"])[0]
    # the loss with the MoE load-balance term (ce without one)
    return float(loss), float(jnp.abs(logits.astype(jnp.float32)).max()), flat_leaves(grads)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inp = _inputs()
    return inp, _run(tmp_path_factory.mktemp("gloo4"), 4, 2, 2, inp)


def _leaves(tree, path=()):
    """(key path, array) of each leaf of a dict tree (None leaves skipped)."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, path + (k,))]
    return [] if tree is None else [(path, np.asarray(tree, np.float32))]


def _serving_within(got, inp, arch, key, sites, rows=None):
    tokens = inp["tokens"][:rows]
    want, want_cache = _ref_serving(inp, tokens, arch, key)
    for g, w in zip(got["logits"], want):
        assert g.shape == w.shape and np.isfinite(g).all()
        err, tol = float(np.abs(g - w).max()), sites * U * float(np.abs(w).max())
        assert err <= tol, (err, tol)
    for path, w in _leaves(want_cache):
        g = got["cache"]
        for k in path:
            g = g[k]
        err = float(np.abs(g - w).max())
        assert err <= sites * U * float(np.abs(w).max()), path
    # control: repro's logits for the tokens shifted by one are beyond the bound
    shifted, _ = _ref_serving(inp, np.roll(tokens, 1, axis=1), arch, key)
    w = shifted[0]
    assert float(np.abs(got["logits"][0] - w).max()) > sites * U * float(np.abs(w).max())


def _train_within(got, inp, arch, key, batch_key):
    cfg = SMOKE_CONFIGS[arch]
    labels = inp[f"{batch_key}_labels"]
    loss, max_logit, want = _ref_grads(inp, labels, arch, key, batch_key)
    assert abs(float(got["loss"]) - loss) <= 2 * forward_sites(cfg) * U * max_logit
    index = leaf_index(REF_SMOKE[arch], inp[f"{key}_params"])
    sites = grad_sites(cfg, inp[f"{batch_key}_tokens"])

    def errors(want_flat):
        return {n: (float(np.abs(g.ravel() - want_flat[index[n]]).max()),
                    sites * U * float(np.abs(want_flat[index[n]]).max()))
                for n, g in got["grads"].items()}

    errs = errors(want)
    assert all(e <= t for e, t in errs.values()), {n: v for n, v in errs.items() if v[0] > v[1]}
    _, _, shifted = _ref_grads(inp, np.roll(labels, 1, axis=1), arch, key, batch_key)
    assert any(e > t for e, t in errors(shifted).values())


def test_sharded_serving_on_four_processes_within_the_serving_bound(four):
    inp, out = four
    _serving_within(out["sharded"], inp, "qwen3-4b", "qwen_params",
                    model_sites(REF_SMOKE["qwen3-4b"].n_layers))


def test_sharded_train_step_on_four_processes_within_the_loss_bounds(four):
    inp, out = four
    _train_within(out["sharded"]["train"], inp, "tinyllama-1.1b", "tiny", "train")


def test_sharded_moe_serving_on_four_processes_within_the_serving_bound(four):
    inp, out = four
    _serving_within(out["sharded"]["moe"], inp, MOE, "moe_params", sites(SMOKE_CONFIGS[MOE]))


def test_sharded_moe_train_step_on_four_processes_within_the_loss_bounds(four):
    inp, out = four
    _train_within(out["sharded"]["moe"]["train"], inp, MOE, "moe_train", "moe_train")


@pytest.mark.parametrize("arch", RECURRENT)
def test_sharded_recurrent_serving_at_b2_on_four_processes_within_the_serving_bound(four, arch):
    """B 2 on (2, 2): the batch takes "data", "model" is the cells' (the
    mLSTM decode in the state's split, each device its Mamba2 heads)."""
    inp, out = four
    _serving_within(out["sharded"][arch], inp, arch, f"{arch}_params",
                    forward_sites(SMOKE_CONFIGS[arch]), rows=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [S, S - 1], ids=["even", "uneven"])
def test_attention_on_a_query_sequence_shard_on_four_processes(four, causal, seq):
    """Each device's query rows (from its q_start) against k and v whole,
    on a 2-way "model" axis that divides the sequence and on one that does
    not: the output and the gradients of q, k and v within 1e-5·max of the
    plain attention on the whole tensors; the control, the other mask's
    output, beyond it."""
    import torch

    from repro_torch.models.common import PLAIN

    _, out = four
    got = out["sharded"]["attention"][seq, causal]
    gen = torch.Generator().manual_seed(5)
    q, k, v, w = (torch.randn(B, seq, n, 16, generator=gen) for n in (3, 1, 1, 3))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = PLAIN.attention(*ins, causal)
    (o * w).sum().backward()
    want = {"out": o.detach().numpy(), **{n: t.grad.numpy() for n, t in zip("qkv", ins)}}
    for name, w_ in want.items():
        assert np.abs(got[name] - w_).max() <= 1e-5 * np.abs(w_).max(), name
    other = out["sharded"]["attention"][seq, not causal]["out"]
    assert np.abs(other - want["out"]).max() > 1e-5 * np.abs(want["out"]).max()


def test_one_process_mesh_is_bitwise_the_unsharded_cells(tmp_path):
    out = _run(tmp_path, 1, 1, 1, _inputs())
    for a, b in ((out["sharded"], out["whole"]), (out["sharded"]["moe"], out["whole"]["moe"])):
        for x, y in zip(a["logits"], b["logits"]):
            assert np.array_equal(x, y)
        for name in a["cache"]:
            assert np.array_equal(a["cache"][name], b["cache"][name]), name
        for part in ("loss", "grads", "masters", "m", "v"):
            x, y = a["train"][part], b["train"][part]
            if isinstance(x, dict):
                for n in x:
                    assert np.array_equal(x[n], y[n]), (part, n)
            else:
                assert np.array_equal(x, y), part
    for key, cell in out["sharded"]["attention"].items():
        for name, x in cell.items():
            assert np.array_equal(x, out["whole"]["attention"][key][name]), (key, name)
    for arch in RECURRENT:
        a, b = out["sharded"][arch], out["whole"][arch]
        for x, y in zip(a["logits"], b["logits"]):
            assert np.array_equal(x, y), arch
        for (path, x), (_, y) in zip(_leaves(a["cache"]), _leaves(b["cache"])):
            assert np.array_equal(x, y), (arch, path)


@pytest.mark.parametrize("part", ["serving", "train"])
@pytest.mark.parametrize("arch", ["qwen3-4b", MOE])
def test_graphed_sharded_cells_equal_the_eager_ones_on_four_processes(four, arch, part):
    _, out = four
    got = out["graphed"][arch][part]
    if part == "serving":
        want = out["sharded"] if arch == "qwen3-4b" else out["sharded"]["moe"]
        assert len(got["logits"]) == len(want["logits"]) == 1 + N_DECODE
    else:
        want = out["graphed"][arch]["train_eager"]
        assert want["captures"] == [0]
    assert got["captures"] == ([1, 1] if part == "serving" else [1])
    parts = [k for k in got if k != "captures"]
    a, b = _leaves({k: got[k] for k in parts}), _leaves({k: want[k] for k in parts})
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 2
    for (path, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y), (arch, part, path)
