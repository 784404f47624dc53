"""End-to-end burst-checkpointed training driver (``repro/launch/train.py``).

Fault tolerance is the paper's Algorithm 1: train in bursts of k steps,
checkpoint and atomically commit the burst index after each burst, resume
from the committed index after any crash (the deterministic data pipeline
regenerates the exact batches). ``--crash-after-burst N`` ends the process
(exit code 1) right after burst N commits; rerunning the same command
resumes and continues the same trajectory.

The smoke config is the default, as in ``repro``; ``--full`` trains the
architecture at full width with random weights from seed 0. Every
family trains: the loss is ``api.loss`` on the plain tensor code under
autograd (``repro``'s loss reaches no Pallas kernel; the port's CUDA kernels
have no backward and their wrappers refuse tensors that need one), remat as
in ``repro``, and AdamW on the float32 masters, which are cast back into the
module's bfloat16 and float32 weights after each update
(``models/api.py``). vlm and encdec take ``repro``'s zero stand-ins for the
vision tokens and audio frames.

**The compiled step.** ``repro`` jits its step with the parameters and
the optimizer state donated (``jax.jit(step_fn, donate_argnums=(0, 1))``).
On a card :func:`train` runs each step as a replay of one CUDA graph per
(model, train state, batch input shapes) (:class:`_GraphedTrainStep`): the
graph's static inputs are the batch, and it updates the module's weights,
the float32 masters, AdamW's moments and its step counter in place, so
there is no copy and no second state, the counterpart of the donation. A
shape's first step runs eagerly on a side stream, and is that step, before
the capture; the capture itself runs nothing. On the CPU :func:`train`
runs the eager :func:`train_step`. ``TRACE_COUNT["step"]`` counts captures
on a card and builds of the eager step on the CPU, as the serve module's
``TRACE_COUNT`` does.

**Sharded training.** ``train(..., mesh=...)`` lays the module, the float32
masters, AdamW's moments and each batch out over a device mesh as
``launch/steps.py``'s sharded cells do (``api.param_logical``, the batch
along "batch") and runs each step under ``implicit_replication`` through
``sharding.sharded(PLAIN, rules)``: on a card as a replay of one CUDA graph
per (model, train state, batch shapes) on that mesh, a
:class:`_GraphedTrainStep` whose static inputs are DTensors and whose
graph holds the step's NCCL collectives (the counterpart of ``repro``'s
jitted, donated step under the mesh); on the CPU eagerly. Each step returns
the loss whole. A checkpoint gathers the state whole and process 0 writes
it; a resumed run lays the restored state out again.
``--production-mesh`` (``--multi-pod`` for two pods) builds ``repro``'s
production mesh over the processes ``torchrun`` launched (``RANK``,
``WORLD_SIZE``; the group starts from a ``FileStore`` beside the
checkpoints, never an address) and refuses any count but 256 (512), naming
it, as ``jax.make_mesh`` does.

Usage:
    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50 --device cpu
    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50 --device cpu \\
        --crash-after-burst 2   # then rerun without the flag to resume
    python -m repro_torch.launch.train --plan-bursts
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint.burst_ckpt import BurstCheckpointer, plan_burst_schedule
from ..configs import SMOKE_CONFIGS, get_config
from ..data.synthetic import SyntheticConfig, SyntheticData
from ..device import resolve_device
from ..models import api
from ..configs.base import ShapeConfig
from ..models.common import PLAIN, Kernels
from ..models.sharding import is_dtensor, mesh_scope, rules_for, sharded
from ..obs.metrics import METRICS
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from . import serve
from .mesh import init_local_group, make_production_mesh, production_shape, torchrun_rank

__all__ = ["train", "train_step", "batch_tensors", "stand_ins", "main", "TRACE_COUNT"]

TRACE_COUNT = METRICS.counter_dict("train.trace_count", ("step",))


def stand_ins(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The family's zero stand-ins, as ``repro``'s train step makes them:
    vlm's vision tokens, encdec's audio frames (none for the others)."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in api.extra_inputs(cfg, batch).items()}


def batch_tensors(cfg, batch: Dict[str, np.ndarray], device,
                  extra: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """A synthetic batch on ``device``: int64 tokens and labels, and
    ``extra`` (the family's zero stand-ins when None)."""
    out = {k: torch.from_numpy(batch[k]).to(device=device, dtype=torch.int64)
           for k in ("tokens", "labels")}
    if extra is None:
        extra = stand_ins(cfg, out["tokens"].shape[0], device)
    return {**out, **extra}


def train_step(cfg, model, state, adamw: AdamWConfig,
               batch: Dict[str, torch.Tensor], remat: bool = True,
               kernels: Kernels = PLAIN) -> torch.Tensor:
    """One step: the loss and its gradients through autograd (the plain
    versions, with remat unless ``remat`` is False), AdamW on the float32
    masters ``state["params"]`` and the moments of ``state["opt_state"]`` in
    place, then the masters cast into the module. Returns the loss before
    the update, a 0-d float32 tensor. A sharded step passes
    ``sharding.sharded(PLAIN, rules)`` as ``kernels``."""
    for p in model.parameters():
        p.grad = None
    loss, _ = api.loss(cfg, model, batch, remat=remat, kernels=kernels)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    adamw_update(adamw, state["params"], grads, state["opt_state"])
    api.load_masters(model, state["params"])
    return loss.detach()


class _GraphedTrainStep:
    """:func:`train_step` on a card as one CUDA graph per (model, train
    state, batch input shapes): ``step(model, state, batch)`` returns the
    step's loss, a 0-d float32 tensor. ``step``, the eager step it
    captures (``step(model, state, batch) -> loss``), defaults to
    :func:`train_step` with ``adamw``; a sharded one (the model, state and
    batch DTensors on a mesh, the loss a replicated DTensor) has its NCCL
    collectives recorded into the graph.

    The graphs live in a ``WeakKeyDictionary`` on the model, keyed inside by
    the state and :func:`serve._input_key` of the batch (int64 tokens and
    labels [B, S], and the vlm's or encdec's zero stand-in). The batch is
    the graph's static input. The graph closes over the module's
    parameters and the tensors of ``state`` (the float32 masters, AdamW's m
    and v and its 0-d step counter) and updates them in place, so they must
    stay the same tensors: a call whose state holds other tensors than at
    the capture raises. A shape's first call runs one real step on a side
    stream (:func:`serve._capture`), whose loss it returns; then the
    gradients go (``grad`` None), so the backward under capture allocates
    them in the graph's private pool, and the capture runs nothing. Later
    calls copy the batch in and replay; each returns a clone of the loss.
    ``graphs(model)``: {key: :class:`serve._Captured`}, for the captures'
    stats."""

    def __init__(self, cfg, adamw: AdamWConfig, dev: torch.device, step=None):
        self.dev = dev
        self.step = step or (lambda model, state, batch:
                             train_step(cfg, model, state, adamw, batch))
        self._graphs: "weakref.WeakKeyDictionary[Any, Dict[tuple, Any]]" = (
            weakref.WeakKeyDictionary())

    def graphs(self, model) -> Dict[tuple, Any]:
        return self._graphs.setdefault(model, {})

    def __call__(self, model, state, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        graphs = self.graphs(model)
        key = (id(state),) + serve._input_key(batch)
        cap = graphs.get(key)
        if cap is None:
            eager = self.step

            def step(s):
                loss = eager(model, state, s)
                model.zero_grad(set_to_none=True)
                return {"loss": loss}

            cap, out = serve._capture(step, batch, self.dev)
            # the graph writes these: they stay alive, and the key's id unique
            cap.state, cap.state_leaves = state, list(serve._leaves(state))
            graphs[key] = cap
            TRACE_COUNT["step"] += 1
        else:
            now = list(serve._leaves(state))
            if len(now) != len(cap.state_leaves) or any(
                    a is not b for a, b in zip(now, cap.state_leaves)):
                raise ValueError("the train state holds other tensors than at the capture")
            out = cap(batch)
        return out["loss"]


def _step_fn(cfg, adamw: AdamWConfig, dev: torch.device):
    """:func:`train`'s ``step(model, state, batch) -> loss``: a
    :class:`_GraphedTrainStep` on a card, the eager :func:`train_step` on
    the CPU (a build, counted in ``TRACE_COUNT``)."""
    if dev.type == "cuda":
        return _GraphedTrainStep(cfg, adamw, dev)
    TRACE_COUNT["step"] += 1
    return lambda model, state, batch: train_step(cfg, model, state, adamw, batch)


def _sharded_step_fn(cfg, adamw: AdamWConfig, mesh, dev: torch.device):
    """:func:`train`'s ``step`` on a mesh, and its :class:`_GraphedTrainStep`
    (None on the CPU): the batch laid out along "batch", then the sharded
    :func:`train_step` (``sharding.sharded(PLAIN, rules)`` under
    ``implicit_replication``), on a card the graph's replay, on the CPU
    eager (a build, counted in ``TRACE_COUNT``); each step returns the
    loss, whole."""
    from .steps import shard_batch

    kernels = sharded(PLAIN, rules_for(cfg.family))

    def eager(model, state, batch):
        with mesh_scope(mesh):
            return train_step(cfg, model, state, adamw, batch, kernels=kernels)

    if dev.type == "cuda":
        graphed = run = _GraphedTrainStep(cfg, adamw, dev, step=eager)
    else:
        graphed, run = None, eager
        TRACE_COUNT["step"] += 1

    def step(model, state, batch):
        loss = run(model, state, shard_batch(cfg, batch, mesh))
        return loss.full_tensor() if is_dtensor(loss) else loss
    return step, graphed


def _on_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _gathered(tree):
    """A tree of tensors and DTensors with every DTensor made whole."""
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return tree.full_tensor() if is_dtensor(tree) else tree


def production_mesh_of_launch(multi_pod: bool, ckpt_dir: str, device):
    """``repro``'s production mesh over ``torchrun``'s processes: the
    launch's process count is checked first (``ValueError`` naming it),
    then the default group starts from a ``FileStore`` in ``ckpt_dir``."""
    shape, _ = production_shape(multi_pod)
    rank, world = torchrun_rank() or (0, 1)
    need = math.prod(shape)
    if world != need:
        raise ValueError(f"--production-mesh: the {'x'.join(map(str, shape))} mesh needs "
                         f"{need} processes, this launch has {world}")
    dev = torch.device(device)
    os.makedirs(ckpt_dir, exist_ok=True)
    init_local_group(rank, world, "nccl" if dev.type == "cuda" else "gloo",
                     path=os.path.join(ckpt_dir, "process_group_store"))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    return make_production_mesh(multi_pod, dev.type)


def train(arch: str, steps: int, batch: int, seq: int, burst_steps: int, ckpt_dir: str,
          smoke: bool = True, crash_after_burst: int = -1, seed: int = 0,
          log_every: int = 10, lr: float = 1e-3, device="cuda",
          report: Optional[dict] = None, mesh=None):
    """Train ``arch`` for ``steps`` steps of ``batch`` × ``seq`` tokens in
    bursts of ``burst_steps``, committing a checkpoint under ``ckpt_dir``
    after each; resumes from the last committed burst there. Returns the
    losses of the steps this call ran. On a card each step is a CUDA graph
    replay, the first one its capture (module docstring). ``report``, if
    given, receives "step_seconds" (each step's host time to its loss,
    which waits for the card; a capture's included), "commits" ({"burst",
    "seconds", "bytes"} each) and "captures" (each capture's ``stats``:
    "capture_s", "instantiate_s", "pool_bytes"; none on the CPU). With
    ``mesh`` the run is sharded over it (module docstring); every process
    of the mesh calls this with the same arguments."""
    dev = resolve_device(device)
    cfg = SMOKE_CONFIGS[arch] if smoke else get_config(arch)
    adamw = AdamWConfig(lr=lr, warmup_steps=20)
    data = SyntheticData(SyntheticConfig(cfg.vocab, seq, batch, seed=seed))
    ck = BurstCheckpointer(ckpt_dir)
    report = {} if report is None else report
    report.update(step_seconds=[], commits=[], captures=[])

    restored = ck.restore()
    model, masters = api.init_trainable(cfg, seed, dev, max_seq=seq)
    if restored is None:
        state = {"params": masters, "opt_state": adamw_init(masters)}
        start_burst = 0
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[train] fresh start: {arch} ({cfg.name}), {n_params / 1e6:.1f}M params")
    else:
        del masters
        start_burst, host = restored
        state = _on_device(host, dev)
        api.load_masters(model, state["params"])
        print(f"[train] resumed from burst {start_burst} (step {start_burst * burst_steps})")

    if mesh is not None:
        from .steps import CellSpec

        lay = CellSpec(cfg, ShapeConfig("train", seq, batch, "train"), dev, None, (), mesh=mesh)
        model, state, _ = lay.shard((model, state, {}))
    extra = stand_ins(cfg, batch, dev)
    if mesh is None:
        step_fn = _step_fn(cfg, adamw, dev)
        graphed = step_fn if isinstance(step_fn, _GraphedTrainStep) else None
    else:
        step_fn, graphed = _sharded_step_fn(cfg, adamw, mesh, dev)
    n_bursts = (steps + burst_steps - 1) // burst_steps
    losses = []
    for burst in range(start_burst, n_bursts):
        t0 = time.time()
        for s in range(burst * burst_steps, min((burst + 1) * burst_steps, steps)):
            ts = time.perf_counter()
            b = batch_tensors(cfg, data.batch(s), dev, extra)
            loss = float(step_fn(model, state, b))
            report["step_seconds"].append(time.perf_counter() - ts)
            losses.append(loss)
            if s % log_every == 0:
                print(f"[train] step {s:5d}  loss {loss:.4f}  "
                      f"({time.time() - t0:.1f}s into burst {burst})")
        tc = time.perf_counter()
        if mesh is None:
            nbytes = ck.save(burst + 1, state)
        else:  # the state gathered whole on every process, written by process 0
            whole = _gathered(state)
            nbytes = ck.save(burst + 1, whole) if torch.distributed.get_rank() == 0 else 0
            torch.distributed.barrier()
        report["commits"].append({"burst": burst + 1, "seconds": time.perf_counter() - tc,
                                  "bytes": nbytes})
        print(f"[train] burst {burst + 1}/{n_bursts} committed ({time.time() - t0:.1f}s)")
        if crash_after_burst == burst + 1:
            print("[train] injected crash! rerun to resume.", flush=True)
            sys.stderr.flush()
            os._exit(1)
    if graphed is not None:
        report["captures"] = [cap.stats for cap in graphed.graphs(model).values()]
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} → last {losses[-1]:.4f}")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--burst-steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--crash-after-burst", type=int, default=-1)
    ap.add_argument("--plan-bursts", action="store_true",
                    help="print the julienne checkpoint-cadence plan and exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over repro's 16x16 mesh: 256 processes launched by torchrun")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: the 2x16x16 mesh, 512 processes")
    args = ap.parse_args(argv)
    if args.plan_bursts:
        part = plan_burst_schedule(args.steps, step_seconds=1.0,
                                   state_bytes=10**9, max_loss_seconds=60.0)
        print(part.summary())
        print("burst bounds:", part.bounds)
        return 0
    mesh = None
    if args.production_mesh:
        mesh = production_mesh_of_launch(args.multi_pod, args.ckpt_dir, args.device)
    elif args.multi_pod:
        ap.error("--multi-pod goes with --production-mesh")
    train(args.arch, args.steps, args.batch, args.seq, args.burst_steps, args.ckpt_dir,
          smoke=not args.full, crash_after_burst=args.crash_after_burst, device=args.device,
          mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
