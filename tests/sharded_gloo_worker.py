"""One process of a sharded run on the CPU, for ``tests/test_torch_sharded_run.py``.

    python tests/sharded_gloo_worker.py RANK WORLD MESH_ROWS MESH_COLS WORKDIR

Every process starts a gloo group from a ``FileStore`` in WORKDIR, lays the
cells out on a (MESH_ROWS, MESH_COLS) ("data", "model") mesh and runs them
on the CPU through ``launch/steps.py``'s sharded cells, with the parameters
of ``WORKDIR/inputs.pkl`` (``repro``'s, as numpy, carried across by
``api.params_from_numpy``):

* qwen3-4b (smoke): a prefill of ``tokens``, then one decode step per
  column of ``decode_tokens`` (teacher-forced);
* tinyllama-1.1b (smoke): one train step on ``train_tokens`` /
  ``train_labels``;
* granite-moe-1b-a400m (smoke): the same prefill and decode steps, and a
  train step on ``moe_train_tokens`` / ``moe_train_labels`` (its experts
  split over "model": the tokens exchanged by all-to-all in the prefill and
  the train step, the decode's tokens whole there);
* xlstm-1.3b and zamba2-7b (smoke): the prefill and decode steps of the
  first 2 rows, which leave "model" to the recurrent cells (the mLSTM step
  in the state's split, each device its Mamba2 heads);
* attention on a query sequence shard: q [B, S, 3, 16], k, v [B, S, 1, 16]
  (3 heads, which "model" does not divide; S the prompt's length and one
  less, which "model" does not divide either) as DTensors along the batch
  and the sequence, through the sharded bundle's plain attention, causal
  and not, forward and the gradients of a seeded weighting of the output;

and, when MESH is (1, 1), the same cells unsharded; on a larger mesh, under
"graphed", the sharded cells of qwen3-4b and granite-moe-1b-a400m as CUDA
graphs with the capture made eager (``helpers_torch.eager_record``): the
prefill twice (a capture, then a replay) and the decode steps through
``CellSpec.replay``, and two train steps through ``CellSpec.replay``
beside two through ``CellSpec.run_eager`` (each loss, then the masters and
moments), with the captures each cell made. Process 0 writes each result
whole (logits, the cache, the loss, each gradient, the masters and moments
after the step) to ``WORKDIR/out_<rows>x<cols>.pkl``.
"""

import contextlib
import os
import pickle
import sys

import torch


def main(rank, world, rows, cols, workdir):
    torch.manual_seed(0)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SMOKE_CONFIGS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import build_cell, shard_batch
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS
    from repro_torch.models.sharding import is_dtensor, rules_for, sharded
    from repro_torch.optim.adamw import adamw_init

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    mesh_mod.init_local_group(rank, world, "gloo", path=os.path.join(workdir, "store"))
    mesh = init_device_mesh("cpu", (rows, cols), mesh_dim_names=("data", "model"))

    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(whole(v) for v in tree)
        if tree is None:
            return None
        t = tree.full_tensor() if is_dtensor(tree) else tree
        return t.detach().to(torch.float32).numpy() if t.is_floating_point() else t.numpy()

    def serve(arch, params, m, rows=None):
        cfg = SMOKE_CONFIGS[arch]
        tokens = torch.from_numpy(inp["tokens"][:rows])
        b, s = tokens.shape
        max_seq = inp["max_seq"]
        model = api.params_from_numpy(cfg, inp[params], "cpu")
        prefill = build_cell(cfg, ShapeConfig("p", s, b, "prefill"), "cpu", mesh=m)
        args = prefill.shard((model, {"tokens": tokens}))
        # the prompt prefilled through the api with the cache padded to max_seq
        kernels = KERNELS if m is None else sharded(KERNELS, rules_for(cfg.family))
        scope = contextlib.nullcontext() if m is None else implicit_replication()
        with scope:
            logits, cache = api.prefill(cfg, args[0], args[1], max_seq, kernels)
            steps = [whole(logits)]
            dec = build_cell(cfg, ShapeConfig("d", max_seq, b, "decode"), "cpu", mesh=m)
            for j in range(inp["decode_tokens"].shape[1]):
                tok = torch.from_numpy(inp["decode_tokens"][:rows, j:j + 1].copy())
                if m is not None:
                    tok = shard_batch(cfg, {"t": tok}, m)["t"]
                lg, cache = dec.fn(args[0], cache, tok, torch.tensor(s + j), kernels=kernels)
                steps.append(whole(lg))
        return {"logits": steps, "cache": whole(cache)}

    def train(arch, params, m, batch="train"):
        tcfg = SMOKE_CONFIGS[arch]
        tb = {"tokens": torch.from_numpy(inp[f"{batch}_tokens"]),
              "labels": torch.from_numpy(inp[f"{batch}_labels"])}
        tmodel, masters = api.trainable_from_numpy(tcfg, inp[params], "cpu")
        bt, st = tb["tokens"].shape
        tcell = build_cell(tcfg, ShapeConfig("t", st, bt, "train"), "cpu", mesh=m)
        targs = tcell.shard((tmodel, {"params": masters, "opt_state": adamw_init(masters)},
                             tb))
        loss = tcell.run(targs)
        return {"loss": whole(loss), "grads": {n: whole(p.grad)
                                               for n, p in targs[0].named_parameters()},
                "masters": whole(targs[1]["params"]),
                "m": whole(targs[1]["opt_state"]["m"]), "v": whole(targs[1]["opt_state"]["v"])}

    def captures(model, *cells):
        return [len(cell.graphs(model)) for cell in cells]

    def serve_graphed(arch, params, m):
        cfg = SMOKE_CONFIGS[arch]
        tokens = torch.from_numpy(inp["tokens"])
        b, s = tokens.shape
        max_seq = inp["max_seq"]
        model = api.params_from_numpy(cfg, inp[params], "cpu")
        prefill = build_cell(cfg, ShapeConfig("p", s, b, "prefill"), "cpu", mesh=m,
                             max_seq=max_seq)
        args = prefill.shard((model, {"tokens": tokens}))
        prefill.replay(args)
        logits, cache = prefill.replay(args)
        steps = [whole(logits)]
        dec = build_cell(cfg, ShapeConfig("d", max_seq, b, "decode"), "cpu", mesh=m)
        for j in range(inp["decode_tokens"].shape[1]):
            tok = shard_batch(cfg, {"t": torch.from_numpy(
                inp["decode_tokens"][:, j:j + 1].copy())}, m)["t"]
            lg, cache = dec.replay((args[0], cache, tok, torch.tensor(s + j)))
            steps.append(whole(lg))
        return {"logits": steps, "cache": whole(cache),
                "captures": captures(args[0], prefill, dec)}

    def train_steps(arch, params, m, batch, graphed):
        tcfg = SMOKE_CONFIGS[arch]
        tb = {"tokens": torch.from_numpy(inp[f"{batch}_tokens"]),
              "labels": torch.from_numpy(inp[f"{batch}_labels"])}
        tmodel, masters = api.trainable_from_numpy(tcfg, inp[params], "cpu")
        bt, st = tb["tokens"].shape
        tcell = build_cell(tcfg, ShapeConfig("t", st, bt, "train"), "cpu", mesh=m)
        targs = tcell.shard((tmodel, {"params": masters, "opt_state": adamw_init(masters)},
                             tb))
        run = tcell.replay if graphed else tcell.run_eager
        return {"loss": [whole(run(targs)) for _ in range(2)],
                "masters": whole(targs[1]["params"]),
                "m": whole(targs[1]["opt_state"]["m"]), "v": whole(targs[1]["opt_state"]["v"]),
                "captures": captures(targs[0], tcell)}

    def graphed(m):
        from helpers_torch import eager_record

        from repro_torch.launch import serve as serve_mod

        record, serve_mod._record = serve_mod._record, eager_record
        try:
            out = {}
            for arch, params, train_params, batch in (
                    ("qwen3-4b", "qwen_params", "tiny_params", "train"),
                    ("granite-moe-1b-a400m", "moe_params", "moe_train_params", "moe_train")):
                tarch = "tinyllama-1.1b" if arch == "qwen3-4b" else arch
                out[arch] = {"serving": serve_graphed(arch, params, m),
                             "train": train_steps(tarch, train_params, m, batch, True),
                             "train_eager": train_steps(tarch, train_params, m, batch, False)}
            return out
        finally:
            serve_mod._record = record

    def attention(m):
        from torch.distributed.tensor import Shard, distribute_tensor

        from repro_torch.models.common import PLAIN

        fn = PLAIN.attention if m is None else sharded(PLAIN, rules_for("dense")).attention
        got = {}
        for s in (inp["tokens"].shape[1], inp["tokens"].shape[1] - 1):  # "model" divides one
            gen = torch.Generator().manual_seed(5)
            q, k, v, w = (torch.randn(inp["tokens"].shape[0], s, n, 16, generator=gen)
                          for n in (3, 1, 1, 3))
            for causal in (True, False):
                ins = [t.clone() if m is None else distribute_tensor(t, m, [Shard(0), Shard(1)])
                       for t in (q, k, v, w)]
                for t in ins[:3]:
                    t.requires_grad_(True)
                o = fn(*ins[:3], causal)
                (o * ins[3]).sum().backward()
                got[s, causal] = {"out": whole(o),
                                  **{n: whole(t.grad) for n, t in zip("qkv", ins)}}
        return got

    out = {}
    meshes = [("sharded", mesh)] + ([("whole", None)] if rows * cols == 1 else [])
    for label, m in meshes:
        out[label] = serve("qwen3-4b", "qwen_params", m)
        out[label]["train"] = train("tinyllama-1.1b", "tiny_params", m)
        out[label]["moe"] = serve("granite-moe-1b-a400m", "moe_params", m)
        out[label]["moe"]["train"] = train("granite-moe-1b-a400m", "moe_train_params", m,
                                           "moe_train")
        out[label]["attention"] = attention(m)
        for arch in ("xlstm-1.3b", "zamba2-7b"):  # B 2: "model" left to the cells' heads
            out[label][arch] = serve(arch, arch + "_params", m, rows=2)
    if rows * cols > 1:
        out["graphed"] = graphed(mesh)
    if rank == 0:
        with open(os.path.join(workdir, f"out_{rows}x{cols}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, rows, cols = (int(a) for a in sys.argv[1:5])
    main(r, w, rows, cols, sys.argv[5])
