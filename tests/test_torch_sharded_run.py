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
  Gloo has every collective these steps take (DTensor moves a shard to
  another dim on a CPU mesh by an all-gather and a chunk, as gloo has no
  all-to-all): no cell is left to the fake backend.
* one process on a (1, 1) mesh: the sharded cells' logits, cache, loss,
  gradients, masters and moments bitwise the unsharded cells'.
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

from repro_torch.configs import SMOKE_CONFIGS

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_SEQ, N_DECODE = 4, 16, 32, 2


def _inputs():
    rs = np.random.RandomState(7)
    qcfg, tcfg = REF_SMOKE["qwen3-4b"], REF_SMOKE["tinyllama-1.1b"]
    qp, _ = ref_api.init_params(qcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    tp, _ = ref_api.init_params(tcfg, jax.random.PRNGKey(1), max_seq=S)
    return {"qwen_params": jax.tree.map(np.asarray, qp),
            "tiny_params": jax.tree.map(np.asarray, tp),
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


def _ref_serving(inp, tokens):
    cfg = REF_SMOKE["qwen3-4b"]
    params = jax.tree.map(jnp.asarray, inp["qwen_params"])
    logits, cache = ref_api.prefill(cfg, params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                    MAX_SEQ)
    out = [np.asarray(logits.astype(jnp.float32))]
    for j in range(N_DECODE):
        tok = jnp.asarray(inp["decode_tokens"][:, j:j + 1], jnp.int32)
        logits, cache = ref_api.decode_step(cfg, params, cache, tok, jnp.int32(S + j))
        out.append(np.asarray(logits.astype(jnp.float32)))
    return out, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), cache)


def _ref_grads(inp, labels):
    cfg = REF_SMOKE["tinyllama-1.1b"]
    params = jax.tree.map(jnp.asarray, inp["tiny_params"])
    batch = {"tokens": jnp.asarray(inp["train_tokens"], jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    (loss, ce), grads = jax.value_and_grad(
        lambda p: ref_api.loss(cfg, p, batch, remat=True), has_aux=True)(params)
    logits = ref_lm_forward(cfg, params, batch["tokens"])[0]
    return float(ce), float(jnp.abs(logits.astype(jnp.float32)).max()), flat_leaves(grads)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inp = _inputs()
    return inp, _run(tmp_path_factory.mktemp("gloo4"), 4, 2, 2, inp)


def test_sharded_serving_on_four_processes_within_the_serving_bound(four):
    inp, out = four
    got = out["sharded"]
    want, want_cache = _ref_serving(inp, inp["tokens"])
    sites = model_sites(REF_SMOKE["qwen3-4b"].n_layers)
    for g, w in zip(got["logits"], want):
        assert g.shape == w.shape and np.isfinite(g).all()
        err, tol = float(np.abs(g - w).max()), sites * U * float(np.abs(w).max())
        assert err <= tol, (err, tol)
    for name in ("k", "v"):
        w = want_cache[name]
        err = float(np.abs(got["cache"][name] - w).max())
        assert err <= sites * U * float(np.abs(w).max()), name
    # control: repro's logits for the tokens shifted by one are beyond the bound
    shifted, _ = _ref_serving(inp, np.roll(inp["tokens"], 1, axis=1))
    w = shifted[0]
    assert float(np.abs(got["logits"][0] - w).max()) > sites * U * float(np.abs(w).max())


def test_sharded_train_step_on_four_processes_within_the_loss_bounds(four):
    inp, out = four
    got = out["sharded"]["train"]
    cfg = SMOKE_CONFIGS["tinyllama-1.1b"]
    ce, max_logit, want = _ref_grads(inp, inp["train_labels"])
    assert abs(float(got["loss"]) - ce) <= 2 * forward_sites(cfg) * U * max_logit
    index = leaf_index(REF_SMOKE["tinyllama-1.1b"], inp["tiny_params"])
    sites = grad_sites(cfg, inp["train_tokens"])

    def errors(want_flat):
        return {n: (float(np.abs(g.ravel() - want_flat[index[n]]).max()),
                    sites * U * float(np.abs(want_flat[index[n]]).max()))
                for n, g in got["grads"].items()}

    errs = errors(want)
    assert all(e <= t for e, t in errs.values()), {n: v for n, v in errs.items() if v[0] > v[1]}
    _, _, shifted = _ref_grads(inp, np.roll(inp["train_labels"], 1, axis=1))
    assert any(e > t for e, t in errors(shifted).values())


def test_one_process_mesh_is_bitwise_the_unsharded_cells(tmp_path):
    out = _run(tmp_path, 1, 1, 1, _inputs())
    a, b = out["sharded"], out["whole"]
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
