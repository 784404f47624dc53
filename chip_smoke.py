#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, measures
the host-offload cost model's constants (pinned copy bandwidth both ways, a
4 KB copy, an empty launch) beside those committed in
``repro_torch.core.cost``, holds each kernel against its plain PyTorch
version on the card, and drives the port's paths:

1. the head count (``repro_torch.launch.headcount.run``: partition the full
   5458-task THERMAL head count on the sweep kernel, then execute the Q_min
   partition under the burst runtime with one injected power failure, every
   CNN task one launch of the frame kernel reading its window from the
   normalized frame), checked against the port's CPU execution; the frame
   kernel is held to its plain version at all 5452 THERMAL windows (a
   window one column over must miss), the batch kernel at N 1, 37, 1000
   and 5452, and a traced atomic execution must launch the CNN kernel once
   per CNN task and nothing else that often; then the Q_min partition again
   under the runtime with the tracer on and one power failure (one burst
   span per attempt, one ``nvm_commit`` instant per commit, equal to
   ``COMMIT_STATS`` and the ``on_commit`` calls, one replay);
2. the plan tables of qwen3-4b (time and memory) and xlstm-1.3b (time) at
   full width, built through the façade on the sweep kernel (the Q grid on
   its minimax mode, the cells on its sum mode, an exact-K solve per
   bucket), each bitwise equal to the same build on the numpy backend; the
   probe must pass at k=8 and see one altered cell, a second build must hit
   the fingerprint cache, and the memory table prices offload and remat
   plans;
3. serving qwen3-4b at full width (``repro_torch.launch.serve.serve``: 36
   layers, d 2560, 4,411,417,600 random parameters from a seed; batch 4 ×
   prompt 512 × 16 tokens, then batch 1 × prompt 1000 × 8 tokens; every
   RMSNorm and every prefill attention through the CUDA kernels), checked
   cell by cell (the flash kernel on the q, k, v of all 72 prefill layers,
   against a rounding-derived bound that a 2^-5 fault exceeds) and against
   the plain path on the same weights;
4. serving xlstm-1.3b at full width (the same ``serve``: 48 layers, d 2048,
   6 groups of 7 mLSTM + 1 sLSTM blocks, random weights from a seed; batch
   4 × prompt 512 × 16 tokens, then batch 1 × prompt 1024 × 8 tokens; every
   mLSTM prefill cell through the chunked-mLSTM kernel), checked cell by
   cell at full width against rounding-derived bounds, and end to end in
   float32 against the plain path on a float32 copy of the weights;
5. each prefill and each decode step of both models is one CUDA graph
   replay (one prefill and one decode capture per request shape, counted by
   ``TRACE_COUNT``; a replay adds the kernel launches its graph holds):
   ``serve_prefill_graphs`` holds the graphed prefill's logits and every
   cache leaf bitwise to the eager prefill's on new inputs, no capture on a
   second request, and prints each capture's recording and instantiation
   seconds and pool bytes and the warm prefill's host time, busy time and
   idle share beside the eager one's; ``serve_step_graphs`` holds the
   graphed decode against the eager masked decode on the same request
   (each step's logits, the tokens, no capture on a second request), with
   decode ms/token and one step's idle share of each path;
6. planned serving (``serve(plan_table=...)``) at full width on the time
   tables the plan_table phase built: qwen3-4b b4 × p512 × g16 in 4 energy
   cycles with one power failure, xlstm-1.3b b1 × p512 × g8 in 3 cycles,
   each equal to unplanned serving in tokens, with one commit per cycle,
   no build, capture or solve on the request path, and the NVM's bytes and
   copy times;
7. the traffic harness over qwen3-4b's planned executor at full width
   (3 arrivals of b1 × p128 × g8 against a harvest pool that defers one),
   tokens equal to unplanned serving, requests/s and latency percentiles;
8. the calibration loop on that run's energy ledger: a measured cost table,
   a replan on the sweep kernel byte-identical to the time table, a probe
   of every cell against the measured profile, a drifted profile refused
   and one inside the tolerance passed, a noisy profile priced at
   confidence 0.9 through the façade bitwise equal to the numpy backend,
   and the serve module's calibration probe;
9. the dense sweep engine (``scan``) on the card: the three tables rebuilt
   in one batched pass each, byte-equal to the kernel's builds, both timed;
   the dense export's bytes, and ``auto`` leaving the full head count
   (about 1.07 GB dense) on the kernel;
10. swarm placement (``repro_torch.launch.swarm.main`` on the card):
   qwen3-4b b4 × 512 and xlstm-1.3b b1 × 1024 at full width over 3 nodes of
   compute scales 1, 1.5, 2 (qwen3-4b also homogeneous), the ns_mini
   fixture and a seeded random 512-task chain over 4 nodes, each on 25
   links × 3 memory × 3 Q scales with each node's NVM at the graph's span
   footprint; each grid solved again on the card and by the
   numpy oracle, all six DP arrays bitwise equal, every feasible plan
   conserving, and the CLI's table byte-equal to the numpy sweep's;
11. the ``dse`` CLI on the card: qwen3-4b's time table with 1, 2 and 3 Q
   shards (digests equal to the plan_table phase's), an extension equal to
   a fresh build of the union grid that solves only the new cells, the
   probe at k=8, ``--calibrate`` on the traffic ledger (passes) and on it
   drifted ×1.8 (refused), and ``--placement`` equal to the swarm phase's
   table for the same spec; sharded sweeps through the façade on the
   kernel, one-point chunks of qwen3-4b's grid and THERMAL's 96-lane grid
   in 5 and in 96 chunks (other cluster layouts), bitwise equal;
12. the model zoo (``zoo``), every earlier model freed first: tinyllama-1.1b,
   qwen1.5-0.5b, granite-moe-1b-a400m, llama-3.2-vision-11b (b4 × p512 ×
   g16), whisper-large-v3 (b4 × p128 × g16 over 1500 audio frames),
   phi3.5-moe-42b-a6.6b (16 of its 32 layers on one card, b4 × p512 × g16;
   ``--multi-card`` runs all 32 over four cards),
   deepseek-coder-33b (b1 × p512 × g8) and zamba2-7b (81 layers: 13 groups
   of 6 Mamba2 blocks, each followed by the shared attention block, and 3
   tail blocks; b4 × p512 × g16 and b1 × p2048 × g8), each served at full
   width with random weights from seed 0 through ``serve`` and the graphed
   prefill and decode (launches, one capture of each per request shape,
   the parameters held beside ``param_count()``; ``serve_prefill_graphs``
   as in 5), the flash kernel held in every prefill cell (causal
   self-attention, the vlm's cross-attention over 1601 vision tokens,
   whisper's 1500 × 1500 encoder and its cross-attention), the kernel path
   against the plain path within a limit derived from rounding with a
   control that must exceed it (for the vlm and whisper also on a seeded
   random stand-in with the vlm gates nonzero), the graphed decode bitwise
   equal to eager, a warm request's prefill ms and decode ms/token, the
   MoE models' dropped share and routing (kernel against plain path; the
   card's against the CPU's), one planned whisper and one planned zamba2
   request, each on a time table the planner CLI builds on the sweep
   kernel, with one power failure, its tokens equal to unplanned serving's;
   and for zamba2, its chunked prefill against its own recurrence (the last
   128 prompt tokens through the graphed decode after a prefill of the
   rest, against one prefill: every layer's float32 state and the last
   logits within twice a rounding reference's reading, a wrong decay in
   one chunk beyond it);
13. training (``train``), every earlier model freed first: the loss runs
   the plain versions under autograd (no RMSNorm, flash or mLSTM kernel
   launches, which the kernels line shows), so each of the ten smoke
   configs takes one loss and gradient on the card, held leaf by leaf to
   the same code on the CPU within the rounding-derived tolerance of
   ``tests/test_torch_loss.py`` (labels shifted by one, the control, must
   exceed it); so does tinyllama-1.1b at full width with 2 of its 22
   layers (b2 × 128); on a card each step of ``train`` is one CUDA graph replay, one capture
   per (model, state, batch shape): ``train_graphs`` holds the graphed
   step bitwise to the eager ``train_step`` over a warm-up and three
   replays (losses, every master, m, v and the counter) for the ten smoke
   configs and tinyllama-1.1b at full width (22 layers, b8 × 128), after
   the eager step has repeated itself bitwise, and a control (the counter
   frozen, as a graph that captured a rebound counter would leave it) must
   differ; xlstm-1.3b at full width takes 4 graphed steps through ``train``
   (b8 × 128, one capture, one commit);
   the train CLI crashes after burst 1 and resumes (qwen1.5-0.5b smoke, 6
   steps, deterministic algorithms, one capture a run), its losses equal to
   an uninterrupted run's within 1e-6; then ``train(smoke=False)`` trains
   tinyllama-1.1b at full width and 11 of its 22 layers (the cut keeps the
   run's time) with ``repro``'s CLI defaults (50 steps of b8 × 128, a
   checkpoint committed every 20 steps under ``build/train``), one capture,
   its loss must fall; a warm step of tinyllama-1.1b (22 layers) and of
   xlstm-1.3b is traced graphed and eager (host ms, busy ms, idle share,
   the capture's seconds and pool bytes), and the checkpoint cadence
   is planned with the measured step time and state bytes on the numpy
   oracle and on the sweep kernel, with equal bursts;
14. the activation solvers (``planners``): ``plan_offload`` at 2·Q_min,
   ``plan_remat`` at 64·Q_min and ``plan_pipeline`` with 8 stages for all
   ten architectures at full width (b16 × 4096; remat b4 × 4096), each
   within its budget, offload and remat ``Infeasible`` at Q_min / 2, with
   ``h100_pipeline_model``'s constants (and a measured card-to-card copy
   when more than one card is visible);
15. the dry run (``dryrun``): ``repro_torch.launch.dryrun.main(["--all",
   ...])`` counts every (architecture × shape) cell of the ten
   architectures at full width on ``meta`` on the host, in worker
   processes (40 records: 8 skipped, ``long_500k`` × the eight quadratic
   architectures, as in ``repro``; 0 errors; each with ``repro``'s keys),
   and runs the cells that fit one card there, each measured step at least
   as long as its roofline bound and its peak at least its arguments; then
   ``build_cell`` at shapes the earlier phases serve (qwen3-4b prefill b4 ×
   512 and decode b4 at 528, xlstm-1.3b prefill b4 × 512, tinyllama-1.1b
   train b8 × 128), counted and run on the card, each a CUDA graph
   (``CellSpec.run``: the first step its capture, the second a replay):
   the counted kernel calls equal to the card's launches for the same step
   and to ``step_launches``;
16. the sharded cells (``sharded``): a one-process NCCL group and
   ``make_host_mesh()``; qwen3-4b's prefill b4 × 512 (twice) and 8 decode
   steps, two tinyllama-1.1b train steps b8 × 128 and a
   granite-moe-1b-a400m prefill b4 × 512 (twice; the bundle's experts)
   through ``build_cell(..., mesh=)``, each cell eager
   (``CellSpec.run_eager``) and as a CUDA graph (``CellSpec.run``: one
   capture per cell and shape), both bitwise the unsharded cell's (logits,
   cache, loss, masters, m, v) with the same RMSNorm and flash launches,
   with warm ms of each; the train CLI on that mesh (``train(...,
   mesh=)``, ``--production-mesh``'s step; tinyllama-1.1b smoke, 4 steps)
   one capture, its losses equal to the one-card run's; with two or
   more cards, the prefill on a (1, n) mesh in n processes too (logits
   within 0.085 a row of one card's, ``CommDebugMode``'s collectives equal
   to the count's); and the dry run per device of repro's 16x16 and
   2x16x16 meshes for qwen3-4b, granite-moe-1b-a400m and xlstm-1.3b at all
   four shapes, counted in a process of its own on half of the CPUs beside
   the earlier phases, every cell directly at its own length (24 records,
   4 skipped; each per-device argument byte count equal to the resolver's
   arithmetic and, times the devices, at least one card's; a collective
   term above 0). From the build on this process keeps the other half of
   the CPUs, and the ``host_paced`` line gives host-bound call times
   without the count and beside it.

``python3 chip_smoke.py --multi-card`` runs phase 16's (1, n) prefill alone
on every visible card, then phi3.5-moe-42b-a6.6b whole (all 32 layers, b4 ×
512) on a (1, n) mesh, its experts split over "model" and the tokens
exchanged by all-to-all: the kernel path's logits within twice a rounding
reference's reading of the plain path (the plain routes replayed), a
control above that limit, ``CommDebugMode``'s collectives equal to the
count's (all-to-alls among them), each card's peak beside the count. Each
of the two prefill cells also runs as a CUDA graph on the n cards: a
replay's logits bitwise the eager cell's, the collectives recorded in the
capture (what each replay launches) equal to the count's, and the warm
host ms of the eager step and of a replay.
The serving kernels' check against their plain versions (before 3) also
holds the flash kernel on a causal query shard (rows from ``q_start`` 384,
the shard of a mesh axis that does not divide the heads) to
``flash_bound``, the same rows launched from 0 as the control.

Each phase prints one JSON line; the kernels line carries launches, times
and bounds measured in this run; the last line is the device summary. Any
mismatch raises, so the exit code is nonzero. Without a card, or without
the rest of the repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense):
# HBM3 bytes/s; float32 and float64 on the CUDA cores (not tensor cores);
# bfloat16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
PEAK_BF16_PER_S = 989e12

CONV_TOL = 1e-5          # max |Δ| ≤ CONV_TOL · max(1, |score|)
CONV_BATCHES = (1, 37, 1000, 5452)   # the batch kernel's checks; 5452: THERMAL's windows
# The shifted-window control (the plain path one column over) must exceed
# CONV_TOL in at least this share of the windows.
CONV_CONTROL_SHARE = 0.9
THERMAL_Q_MIN = 0.13196942
COPY_BYTES = 64 << 20    # the cost_constants phase's bandwidth copies
# Plan tables built on the card at full width: (arch, kind, (batch, seq) buckets).
QWEN_TABLE_BUCKETS = ((1, 128), (1, 512), (1, 1000), (1, 2048), (4, 512), (4, 1024),
                      (8, 512), (8, 2048))
PLAN_TABLES = (("qwen3-4b", "time", QWEN_TABLE_BUCKETS),
               ("qwen3-4b", "memory", QWEN_TABLE_BUCKETS),
               ("xlstm-1.3b", "time", ((1, 128), (1, 512), (1, 1024), (4, 512), (4, 1024),
                                       (8, 2048))))
PLAN_Q_POINTS = 16       # geometric Q points per table, plus the unbounded one
# repro's own tolerances for these kernels (tests/test_kernels.py), absolute
# and relative: |Δ| ≤ tol · (1 + |plain|). The serving kernels are also held
# to bounds derived from rounding (rms_bound here; flash_bound in the flash
# kernel's ref.py), far tighter at the path's shapes.
RMS_TOL = 1e-2
FLASH_TOL = {torch.bfloat16: 0.05, torch.float32: 2e-5}
BF16_STEP = 2.0 ** -7    # bfloat16 spacing relative to the bottom of a binade
# Serving: qwen3-4b at full width; (batch, prompt, generated tokens).
SERVE_ARCH = "qwen3-4b"
SERVE_REQUESTS = ((4, 512, 16), (1, 1000, 8))
SERVE_PARAMS = 4_411_417_600
# Kernel path against plain path, per logits row (one sequence at one step):
# ‖Δ‖₂ / ‖plain‖₂ at most this. It lies between the kernel path's largest
# reading (0.045) and the control's smallest (0.159), near their geometric
# mean (NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6).
SERVE_REL_LIMIT = 0.085


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` as its caller sees them (CUDA
    events around ``reps`` back-to-back calls, warmed): host work between
    launches counts."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_device(fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only, events kept
    across the profiler's cycles); returns {kernel name: (total device µs,
    count)} of what ran on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (_device_us(e), int(e.count)) for e in prof.key_averages()}


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the calls are queued behind a
    spin kernel, so the card runs them back to back whatever the host's pace.
    The spin grows until the host has queued every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        if cycles > 10 ** 10:
            raise RuntimeError("calls could not be queued ahead of the card")
        cycles *= 4


def launch_ms(fn, reps: int, symbol: str) -> dict:
    """{kernel name: (device ms per launch, launches seen)} of each kernel
    whose name holds ``symbol``, over ``reps`` warmed calls of ``fn``: the
    profiler's total duration divided by the launches it recorded."""
    fn()
    rows = profile_device(lambda: [fn() for _ in range(reps)])
    return {k: (t / c / 1e3, c) for k, (t, c) in rows.items() if symbol in k and c and t > 0}


def kernel_ms(fn, reps: int, symbol: str):
    """(device ms per launch of the kernel whose name holds ``symbol``, how,
    "launches the profiler recorded / launches timed"). From the profiler's
    kernel durations; where the profiler saw no such kernel, from
    :func:`queued_ms`."""
    rows = launch_ms(fn, reps, symbol)
    n = sum(c for _, c in rows.values())
    if n:
        return sum(ms * c for ms, c in rows.values()) / n, "profiler", f"{n}/{reps}"
    return queued_ms(fn, reps), "queued_cuda_events", f"0/{reps}"


def least_s(fn, reps: int) -> float:
    """Least host-clock seconds of ``fn`` followed by a synchronize, over
    ``reps`` warmed calls."""
    fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return min(secs)


def cost_constants(dev, lib, card) -> dict:
    """The host-offload cost model's constants as this card gives them:
    pinned host→device and device→host copy bandwidth (64 MB, least of 10),
    a 4 KB copy (the DMA initiation; least of 100) and an empty launch plus
    synchronize (least of 100), each beside the constant committed in
    ``repro_torch.core.cost``."""
    from repro_torch.core import cost
    from repro_torch.kernels.conv_window.kernel import _raw_stream

    n = COPY_BYTES
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card_buf = torch.empty(n, dtype=torch.uint8, device=dev)
    h2d_s = least_s(lambda: card_buf.copy_(host, non_blocking=True), 10)
    d2h_s = least_s(lambda: host.copy_(card_buf, non_blocking=True), 10)
    small_h, small_d = host[:4096], card_buf[:4096]
    dma_s = least_s(lambda: small_d.copy_(small_h, non_blocking=True), 100)
    stream = _raw_stream(dev.index)
    launch_s = least_s(lambda: lib.repro_empty_launch(32, stream), 100)
    return {
        "card": card, "copy_bytes": n,
        "h2d_bytes_per_s": n / h2d_s, "d2h_bytes_per_s": n / d2h_s,
        "pcie_bw_measured": min(n / h2d_s, n / d2h_s),
        "pcie_bw_committed": getattr(cost, "PCIE_BW", None),
        "dma_init_s_measured": dma_s,
        "dma_init_s_committed": getattr(cost, "DMA_INIT_S", None),
        "launch_s_measured": launch_s,
        "launch_s_committed": getattr(cost, "LAUNCH_S", None),
    }


def _same_partition(a, b) -> bool:
    return (a.bounds == b.bounds and [x.total for x in a.bursts] == [x.total for x in b.bursts]
            and a.e_total == b.e_total)


def plan_table_path(cache_dir):
    """The paper's step 4 on the card: every table of PLAN_TABLES built
    through the façade's ``cuda`` backend (Q grid by ``derive_q_grid`` on the
    kernel's minimax mode, cells on its sum mode), an exact-K solve per
    bucket, the probe at k=8, a second build from ``cache_dir``, and the
    offload and remat plans of the memory table. Returns the tables and a
    record per table; the checks against the numpy backend run after."""
    from repro_torch.api import PartitionSpec, solve
    from repro_torch.configs import get_config
    from repro_torch.core.layer_profile import default_cost_model
    from repro_torch.core.plan_table import BUILD_STATS, build_plan_table, probe_plan_table
    from repro_torch.launch.planner import ServePlanner, derive_q_grid, lower_buckets

    out = []
    for arch, kind, buckets in PLAN_TABLES:
        cfg, cm = get_config(arch), default_cost_model(kind)
        t0 = time.perf_counter()
        graphs = lower_buckets(cfg, buckets, kind)
        qs = derive_q_grid(graphs, cm, PLAN_Q_POINTS, backend="cuda")
        table = build_plan_table(cfg, buckets, qs, kind=kind, cost=cm, graphs=graphs,
                                 backend="cuda")
        build_s = time.perf_counter() - t0
        exact_k = []
        for b, g in enumerate(graphs):
            bi = table.buckets().index(buckets[b])
            k0 = int(np.flatnonzero(table.feasible[bi])[0])
            spec = dict(graph=g, cost=cm, objective="exact_k", q_max=table.q_values()[k0],
                        n_bursts=table.plan_at(bi, k0).n_cycles)
            exact_k.append((spec, solve(PartitionSpec(backend="cuda", **spec)).partition()))
        probed = probe_plan_table(table, cfg, k=8, cost=cm, backend="cuda")
        hits = BUILD_STATS["cache_hits"]
        for _ in range(2):
            cached = build_plan_table(cfg, buckets, qs, kind=kind, cost=cm,
                                      cache_dir=str(cache_dir), backend="cuda")
        priced = []
        if kind == "memory":
            planner = ServePlanner(table)
            budget = max(q for q in table.q_values() if q is not None)
            for bt, sq in buckets:
                off = planner.offload_plan(cfg, bt, sq, budget)
                rem = planner.remat_plan(cfg, bt, sq, budget)
                priced.append([bt, sq, off.n_segments, off.pcie_seconds,
                               rem.n_segments, rem.recompute_seconds])
        out.append({"arch": arch, "kind": kind, "cfg": cfg, "cost": cm, "qs": qs,
                    "table": table, "cached": cached, "exact_k": exact_k,
                    "cache_hit": BUILD_STATS["cache_hits"] == hits + 1,
                    "probed": probed, "build_s": build_s, "priced": priced})
    return out


def plan_table_checks(built) -> list:
    """Each cuda-built table against the same build on the numpy backend,
    bitwise; the probe must see one altered cell; exact-K on the kernel
    equals the numpy backend's. Raises on any miss; one record per table."""
    from repro_torch.api import PartitionSpec, solve
    from repro_torch.core.plan_table import (PlanTable, StaleTableError, build_plan_table,
                                             probe_plan_table)

    rows = []
    for t in built:
        table, cfg, cm = t["table"], t["cfg"], t["cost"]
        want = build_plan_table(cfg, table.buckets(), t["qs"], kind=t["kind"], cost=cm,
                                backend="numpy")
        equal = all(np.array_equal(getattr(table, n), getattr(want, n))
                    for n in PlanTable._PAYLOAD)
        same_k = all(_same_partition(got, solve(PartitionSpec(backend="numpy", **spec))
                                     .partition()) for spec, got in t["exact_k"])
        arrays = {n: getattr(table, n).copy() for n in PlanTable._PAYLOAD}
        seg = int(table.seg_ptr[int(np.flatnonzero(table.feasible.reshape(-1))[-1])])
        arrays["cycle_energy"][seg] = np.nextafter(arrays["cycle_energy"][seg], np.inf)
        try:
            probe_plan_table(PlanTable(table.header, **arrays), cfg, k=None, cost=cm,
                             backend="cuda")
            sees_altered = False
        except StaleTableError:
            sees_altered = True
        row = {"arch": t["arch"], "kind": t["kind"], "buckets": table.buckets(),
               "n_q": table.n_q, "cells": int(table.feasible.size),
               "feasible_cells": int(table.feasible.sum()), "build_s": t["build_s"],
               "table_bytes": table.nbytes(), "digest": table.content_digest(),
               "bitwise_equal_numpy_build": equal and table.content_digest() == want.content_digest(),
               "exact_k_equal_numpy": same_k, "probe_k8_clean": t["probed"] == 8,
               "probe_sees_altered_cell": sees_altered, "cache_hit": t["cache_hit"]
               and t["cached"].content_digest() == table.content_digest()}
        if t["priced"]:
            row["offload_remat"] = t["priced"]
        rows.append(row)
        if not all(row[k] for k in ("bitwise_equal_numpy_build", "exact_k_equal_numpy",
                                    "probe_k8_clean", "probe_sees_altered_cell", "cache_hit")):
            raise AssertionError(f"plan table check failed: {row}")
    return rows


def runtime_trace(g, part, dev, atomic_headcount) -> dict:
    """The head count's Q_min partition under the runtime with the tracer on
    and one power failure: one burst span per attempt, one ``nvm_commit`` per
    committed burst (= ``COMMIT_STATS["commits"]`` = ``on_commit`` calls),
    one replay per power failure, the head count of atomic execution."""
    from repro_torch.core.runtime import (COMMIT_STATS, BurstRuntime, MemoryNVM,
                                          PowerFailure, reset_commit_stats)
    from repro_torch.obs.trace import TRACER

    crash_at = part.n_bursts // 2
    fired, commits = [], []

    def crash_once(b, phase):
        if b == crash_at and phase == "executed" and not fired:
            fired.append(b)
            raise PowerFailure(f"injected at burst {b}")

    reset_commit_stats()
    rt = BurstRuntime(g, part, MemoryNVM(), crash_hook=crash_once, on_commit=commits.append,
                      device=dev)
    TRACER.configure(enabled=True)
    t0 = time.perf_counter()
    try:
        out = rt.run_to_completion({})
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    seconds = time.perf_counter() - t0
    names = [e["name"] for e in TRACER.events()]
    TRACER.reset()
    row = {"bursts": part.n_bursts, "power_failures": len(fired),
           "spans": names.count("burst"), "nvm_commits": names.count("nvm_commit"),
           "commit_stats": dict(COMMIT_STATS), "on_commit_calls": len(commits),
           "replays": names.count("replay"), "power_failure_instants": names.count("power_failure"),
           "headcount": int(out["headcount"]), "headcount_atomic": atomic_headcount,
           "seconds_traced": seconds}
    ok = (row["spans"] == rt.stats.bursts_run + len(fired) == part.n_bursts + 1
          and row["nvm_commits"] == COMMIT_STATS["commits"] == len(commits) == part.n_bursts
          and row["replays"] == COMMIT_STATS["replays"] == row["power_failure_instants"]
          == len(fired) == 1
          and row["headcount"] == atomic_headcount)
    row["ok"] = ok
    if not ok:
        raise AssertionError(f"runtime trace check failed: {row}")
    return row


# -- graphs for the sweep comparisons ----------------------------------------


def random_graph(rng: random.Random, gb, n_max: int, dyadic: bool):
    """A random SSA-valid application; ``dyadic`` makes every cost an exact
    dyadic rational so argmin ties are common."""
    b = gb()
    avail = []
    for i in range(rng.randint(0, 2)):
        b.packet(f"e{i}", 2 ** rng.randint(3, 10) if dyadic else rng.randint(1, 4000),
                 external=True)
        avail.append(f"e{i}")
    for t in range(rng.randint(4, n_max)):
        reads = rng.sample(avail, rng.randint(0, min(3, len(avail))))
        writes = []
        for w in range(rng.randint(0, 2)):
            name = f"p{t}_{w}"
            b.packet(name, 2 ** rng.randint(3, 10) if dyadic else rng.randint(1, 4000),
                     keep=rng.random() < 0.3)
            writes.append(name)
        cost = rng.choice([0.25, 0.5, 1.0]) if dyadic else rng.uniform(0.01, 10.0)
        b.task(f"t{t}", reads=reads, writes=writes, cost=cost)
        avail.extend(writes)
    return b.build()


def sweep_modes(q_grid, n_bursts):
    """(label, objective, q_values, n_bursts, k_objective) for the three modes."""
    return [
        ("sum", "sum", q_grid, None, "sum"),
        ("minimax", "minimax", (), None, "sum"),
        ("exact_k_sum", "exact_k", (q_grid[-2],), n_bursts, "sum"),
        ("exact_k_max", "exact_k", (q_grid[-2],), n_bursts, "max"),
    ]


def spread_graph(rng: random.Random, gb, n: int):
    """An application of exactly ``n`` tasks whose reads reach back to any
    earlier packet, so that loads and freed stores span long i-ranges."""
    b = gb()
    b.packet("e0", 512, external=True)
    avail = ["e0"]
    for t in range(n):
        reads = rng.sample(avail, min(len(avail), rng.randint(1, 3)))
        b.packet(f"p{t}", 2 ** rng.randint(3, 10), keep=rng.random() < 0.2)
        b.task(f"t{t}", reads=reads, writes=[f"p{t}"], cost=rng.uniform(0.01, 10.0))
        avail.append(f"p{t}")
    return b.build()


def slice_crossings(csr, lay) -> tuple:
    """(read slots whose loads, and read slots whose freed stores, cover
    i-ranges that cross a boundary between two CTAs' slices of ``lay``)."""
    ptr = csr.read_ptr.astype(np.int64)
    task = np.repeat(np.arange(1, csr.n_tasks + 1), np.diff(ptr))

    def cta(i):
        return (np.asarray(i) - 1) // lay.slice

    loads = (task - 1 > csr.read_lt) & (cta(csr.read_lt + 1) != cta(task - 1))
    freed = ((csr.read_linf == task) & (csr.read_writer >= 1)
             & (cta(np.maximum(np.minimum(csr.read_writer, task - 1), 1)) > 0))
    return int(loads.sum()), int(freed.sum())


# -- the serving path's kernels ----------------------------------------------

# RMSNorm cases: name -> (rows, d, dtype). The first four are qwen3-4b's
# shapes at batch 4 × prompt 512 (ln1/ln2/final, q-norm, k-norm) and in its
# decode steps; the next four xlstm-1.3b's (b4 × 512, b1 × 1024, decode, and
# the float32 copy of the model); the last four reach each of the kernel's
# paths at its edges (a block's two strided passes past d 4096 or for a d
# not a whole number of 16-byte chunks, a warp per row, the widest row held
# in registers).
RMS_CASES = {
    "prefill_d2560": (2048, 2560, torch.bfloat16),
    "prefill_q_norm": (65536, 128, torch.bfloat16),
    "prefill_k_norm": (16384, 128, torch.bfloat16),
    "decode_d2560": (4, 2560, torch.bfloat16),
    "xlstm_prefill_d2048": (2048, 2048, torch.bfloat16),
    "xlstm_prefill_b1_d2048": (1024, 2048, torch.bfloat16),
    "xlstm_decode_d2048": (4, 2048, torch.bfloat16),
    "xlstm_f32_prefill_d2048": (2048, 2048, torch.float32),
    "zamba_shared_cat_d7168": (2048, 7168, torch.bfloat16),
    "zamba_prefill_d3584": (2048, 3584, torch.bfloat16),
    "odd_f32": (333, 4100, torch.float32),
    "odd_warp_bf16": (77, 200, torch.bfloat16),
    "widest_row_f32": (9, 4096, torch.float32),
    "odd_row_bf16": (7, 1001, torch.bfloat16),
}
# Flash cases: name -> (B, Sq, Sk, H, KV, hd, causal, dtype).
FLASH_CASES = {
    "serve_b4_s512": (4, 512, 512, 32, 8, 128, True, torch.bfloat16),
    "serve_b1_s1000": (1, 1000, 1000, 32, 8, 128, True, torch.bfloat16),
    "hd64": (2, 256, 256, 16, 4, 64, True, torch.bfloat16),
    "hd112_zamba2_mha": (1, 512, 512, 32, 32, 112, True, torch.bfloat16),
    "zamba_b4_s512_hd112": (4, 512, 512, 32, 32, 112, True, torch.bfloat16),
    "noncausal_sk_ne_sq": (2, 100, 300, 8, 2, 128, False, torch.bfloat16),
    "f32_serve_b4_s512": (4, 512, 512, 32, 8, 128, True, torch.float32),
    "f32_serve_b1_s1000": (1, 1000, 1000, 32, 8, 128, True, torch.float32),
    "f32_hd64_tail": (1, 200, 200, 8, 2, 64, True, torch.float32),
    "f32_hd128_noncausal": (1, 40, 72, 4, 4, 128, False, torch.float32),
    # the zoo's non-causal cells: llama-3.2-vision's cross-attention over
    # 1601 vision tokens, whisper's encoder and its decoder's cross-attention
    "vlm_cross_b4_s512_sk1601": (4, 512, 1601, 32, 8, 128, False, torch.bfloat16),
    "whisper_encoder_b4_s1500": (4, 1500, 1500, 20, 20, 64, False, torch.bfloat16),
    "whisper_cross_b4_s128_sk1500": (4, 128, 1500, 20, 20, 64, False, torch.bfloat16),
}
# A causal query shard (sharding._sharded_attention on a mesh axis that does
# not divide the heads): the last 128 of serve_b4_s512's 512 query rows from
# position FLASH_Q_START on, against the 512 keys whole.
FLASH_ROWS_CASE, FLASH_Q_START, FLASH_ROWS = "serve_b4_s512", 384, 128


def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def rms_inputs(case, dev, seed=0):
    n, d, dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _randn(gen, (n, d), dtype, dev, 3.0), _randn(gen, (d,), torch.float32, dev)


def flash_inputs(case, dev, seed=0):
    """q, k, v in the kernel's [B·KV, S, G, hd] / [B·KV, S, hd] layout."""
    b, sq, sk, h, kv, hd, _, dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn(gen, (b * kv, sq, h // kv, hd), dtype, dev),
            _randn(gen, (b * kv, sk, hd), dtype, dev), _randn(gen, (b * kv, sk, hd), dtype, dev))


def _held(got, want, limit) -> tuple:
    """(max |Δ|, max |Δ| / limit); raises unless ``got`` is finite and
    |Δ| ≤ ``limit`` (a tensor like ``want``, or a number) everywhere."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    err = (got - want).abs()
    used = float((err / limit).max().item())
    if not bool(torch.isfinite(got).all()) or used > 1.0:
        raise AssertionError(f"kernel off its plain version: max |Δ| {err.max().item()}, "
                             f"{used} of the limit")
    return float(err.max().item()), used


def rms_bound(want, d: int):
    """|Δ| allowed between two RMSNorms of a row of width ``d`` that differ
    only in float32 rounding: the sums of squares in any order (d·2^-24
    each), rsqrt within 2 ulp and the products give (d + 32)·2^-23 relative;
    a bfloat16 output adds one bfloat16 step where the two float32 values
    round apart, and 2^-14 for the rounding of ``want`` itself."""
    rel = (d + 32) * 2.0 ** -23
    if want.dtype == torch.bfloat16:
        rel += BF16_STEP + 2.0 ** -14
    return rel * want.to(torch.float32).abs() + 1e-6


def model_kernel_checks(dev):
    """Each serving kernel against its plain version on the card: within
    repro's tolerance and within the rounding bound (bfloat16 flash and
    every RMSNorm); float32 flash within repro's 2e-5, also at the serving
    shapes."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ref import attention_plain, flash_bound
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    rms_err, flash_err, bound_used = {}, {}, {}
    for name, case in RMS_CASES.items():
        x, w = rms_inputs(case, dev)
        got = rmsnorm_rows_cuda(x, w, 1e-6)
        torch.cuda.synchronize()
        want = rmsnorm_plain(x, w, 1e-6)
        rms_err[name], _ = _held(got, want, RMS_TOL * (1 + want.float().abs()))
        _, bound_used[f"rmsnorm_{name}"] = _held(got, want, rms_bound(want, case[1]))
    for name, case in FLASH_CASES.items():
        q, k, v = flash_inputs(case, dev)
        causal, dtype = case[6], case[7]
        got = flash_attention_bkv_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = attention_plain(q, k, v, causal=causal)
        flash_err[name], used = _held(got, want, FLASH_TOL[dtype] * (1 + want.float().abs()))
        if dtype == torch.bfloat16:
            _, used = _held(got, want, flash_bound(q, k, v, want, causal))
        bound_used[f"flash_{name}"] = used
    flash_err["rows_from_q_start"], bound_used["flash_rows_from_q_start"], control = (
        flash_rows_check(dev))
    emit({"phase": "serving_kernels_vs_plain_on_card", "rmsnorm_max_abs_err": rms_err,
          "flash_max_abs_err": flash_err, "share_of_bound_used": bound_used,
          "tolerance": "repro's |Δ| ≤ tol·(1+|plain|) (rmsnorm 1e-2; flash 0.05 bf16, "
                       "2e-5 f32) and the rounding bounds: rmsnorm (d+32)·2^-23·|plain| "
                       "[+ (2^-7 + 2^-14)·|plain| in bf16] + 1e-6; bf16 flash "
                       "2^-7·|plain| + (2^-8 + Sk·2^-23)·A + 1e-6, A = plain on |v|",
          "flash_rows_from_q_start": {
              "case": FLASH_ROWS_CASE, "q_start": FLASH_Q_START, "rows": FLASH_ROWS,
              "control": "the same rows launched with q_start 0",
              "control_share_of_bound": control}})
    return rms_err, flash_err


def flash_rows_inputs(dev):
    """q's FLASH_ROWS rows from FLASH_Q_START on and k, v whole, of
    FLASH_ROWS_CASE's inputs (kernel layout)."""
    q, k, v = flash_inputs(FLASH_CASES[FLASH_ROWS_CASE], dev)
    return q[:, FLASH_Q_START:FLASH_Q_START + FLASH_ROWS].contiguous(), k, v


def flash_rows_check(dev) -> tuple:
    """The flash kernel on a causal query shard (``q_start`` > 0) within
    ``flash_bound`` of the plain version on the same rows: (max |Δ|, share
    of the bound used, the control's share: the same rows launched with
    ``q_start`` 0, which must exceed the bound)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ref import attention_plain, flash_bound

    q, k, v = flash_rows_inputs(dev)
    got = flash_attention_bkv_cuda(q, k, v, causal=True, q_start=FLASH_Q_START)
    wrong = flash_attention_bkv_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = attention_plain(q, k, v, causal=True, q_start=FLASH_Q_START)
    bound = flash_bound(q, k, v, want, True, FLASH_Q_START)
    err, used = _held(got, want, bound)
    control = float(((wrong.float() - want.float()).abs() / bound).max())
    if not control > 1.0:
        raise AssertionError(f"flash q_start control within the bound ({control}): the check "
                             "does not discriminate")
    return err, used, control


def serve_path(dev, cfg, requests, want_params, want_launches):
    """A serving main path: build ``cfg``'s model at full width, serve
    ``requests`` (batch, prompt, generated tokens) through the kernels and
    the graphed prefill and decode, count the launches (a replay adds the
    launches its graph holds) and the captures (one prefill and one decode
    graph per request shape); each request served again, through the
    graphs' replays, gives the same tokens.
    ``want_params``: (param_count(), the parameter tensors' numel);
    ``want_launches``: {kernel: launches over all the requests}. The
    model's ``max_seq`` (whisper's decoder positions) is the longest
    request's."""
    from repro_torch.launch.serve import TRACE_COUNT, serve
    from repro_torch.models import api

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    max_seq = max(p + g for _, p, g in requests)
    params = api.init_params(cfg, seed=0, device=dev, max_seq=max_seq)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "serve_model", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "param_count": cfg.param_count(),
          "parameter_tensors_numel": n_params, "init_s": time.perf_counter() - t0,
          "weights_gb": sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9})
    if (cfg.param_count(), n_params) != want_params:
        raise AssertionError(f"{cfg.name}: param_count {cfg.param_count()}, tensors "
                             f"{n_params}; want {want_params}")

    torch.cuda.reset_peak_memory_stats(dev)
    counters = serving_launches()
    for fn in counters.values():
        fn.launches = 0
    captures0 = dict(TRACE_COUNT)
    served = []
    t0 = time.perf_counter()
    for b, p, g in requests:
        report = {}
        seqs = serve(cfg.name, b, p, g, smoke=False, seed=0, device=dev, params=params,
                     report=report)
        served.append({"batch": b, "prompt": p, "gen": g, **report,
                       "tokens_ok": bool(seqs.shape == (b, g) and seqs.min() >= 0
                                         and seqs.max() < cfg.vocab), "_tokens": seqs})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    captures = {k: TRACE_COUNT[k] - captures0[k] for k in captures0}
    shapes = len({(b, p, p + g) for b, p, g in requests})
    # the first request of a shape ran the warm-ups the captures follow; a
    # second one replays the graphs: the same tokens
    for r in served:
        again = serve(cfg.name, r["batch"], r["prompt"], r["gen"], smoke=False, seed=0,
                      device=dev, params=params)
        r["replayed_tokens_equal"] = bool(torch.equal(r.pop("_tokens"), again))
    ok = (launches == want_launches and all(r["tokens_ok"] for r in served)
          and captures == {"prefill": shapes, "decode": shapes}
          and all(r["replayed_tokens_equal"] for r in served))
    emit({"phase": "serve_path", "arch": cfg.name, "seconds": seconds, "requests": served,
          "launches": launches, "expected_launches": want_launches,
          "captures": captures, "request_shapes": shapes,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "ok": ok})
    if not ok:
        raise AssertionError(f"{cfg.name} serve path check failed")
    return params, launches


def qwen_expected(cfg):
    """(param_count(), tensors' numel) and launches of qwen3-4b's requests:
    RMSNorm ln1, ln2, q-norm and k-norm in every layer and the final norm
    at every step, one flash launch per layer per prefill."""
    # ModelConfig.param_count() (as in repro) leaves out the q/k-norm
    # weights and counts 2·d for the final norm; the tensors hold d there.
    numel = cfg.param_count() + 2 * cfg.n_layers * cfg.hd - cfg.d_model
    per_step = 4 * cfg.n_layers + 1
    return (SERVE_PARAMS, numel), {
        "rmsnorm": sum(per_step * g for _, _, g in SERVE_REQUESTS),
        "flash_attention": cfg.n_layers * len(SERVE_REQUESTS), "mlstm_chunk": 0}


def xlstm_expected(cfg):
    """(param_count(), tensors' numel) and launches of xlstm-1.3b's
    requests: one RMSNorm per block and the final norm at every step, one
    mLSTM launch per mLSTM block per prefill."""
    # param_count() (as in repro) is not what the tensors hold: ROADMAP.md §3
    per_step = cfg.n_layers + 1
    mlstm_blocks = cfg.n_layers - cfg.n_layers // cfg.slstm_every
    return (XLSTM_PARAMS, XLSTM_PARAMS_HELD), {
        "rmsnorm": sum(per_step * g for _, _, g in XLSTM_REQUESTS), "flash_attention": 0,
        "mlstm_chunk": mlstm_blocks * len(XLSTM_REQUESTS)}


def _scaled_attention(excess: float, first: int):
    """The plain attention with its output scaled by 1 + ``excess`` at query
    positions from ``first`` on."""
    def attention(q, k, v, causal, q_start=0):
        from repro_torch.models.common import PLAIN

        o = PLAIN.attention(q, k, v, causal, q_start=q_start)
        scale = torch.ones(q.shape[1], device=q.device, dtype=torch.float32)
        scale[max(first - q_start, 0):] += excess
        return (o.to(torch.float32) * scale[None, :, None, None]).to(q.dtype)
    return attention


def _float8_attention(q, k, v, causal):
    """The plain attention with its output rounded to float8 e4m3."""
    from repro_torch.models.common import PLAIN

    return PLAIN.attention(q, k, v, causal).to(torch.float8_e4m3fn).to(q.dtype)


def parity_variants():
    """Paths read against the plain path at the prefill, beside the kernel
    path. "control" stands for a kernel that rescales wrongly after its
    first 64-key tile (6% off past position 64); the parity check must
    reject it. The others show what the reading can see: each kernel
    alone, unbiased rounding noise (float8), systematic errors of 1.6% and
    12.5%."""
    from repro_torch.models.common import KERNELS, PLAIN

    def plain_but(**kw):
        return dataclasses.replace(PLAIN, **kw)

    return {
        "control": plain_but(attention=_scaled_attention(2.0 ** -4, 64)),
        "rmsnorm_kernel_only": plain_but(rmsnorm=KERNELS.rmsnorm),
        "flash_kernel_only": plain_but(attention=KERNELS.attention),
        "attention_float8": plain_but(attention=_float8_attention),
        "attention_x(1+2^-6)": plain_but(attention=_scaled_attention(2.0 ** -6, 0)),
        "attention_x(1+2^-3)_past_64": plain_but(attention=_scaled_attention(2.0 ** -3, 64)),
    }


def _row_rel(got, want):
    """‖got − want‖₂ / ‖want‖₂ of each logits row → [rows] float32."""
    g, w = (t.to(torch.float32).reshape(-1, t.shape[-1]) for t in (got, want))
    return (g - w).norm(dim=-1) / w.norm(dim=-1)


def serve_parity(cfg, params, dev):
    """The kernel path against the plain path on the same weights: the last
    prefill position's logits, then decode logits under teacher forcing
    (the plain path is fed the kernel path's tokens). The reading is each
    logits row's ‖Δ‖₂ / ‖plain‖₂; every row must stay within
    SERVE_REL_LIMIT. The variants of :func:`parity_variants` are read at
    the prefill; the control must exceed the limit in every row."""
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN

    variants = parity_variants()
    out = []
    for b, p, g in SERVE_REQUESTS:
        gen = torch.Generator(device=dev).manual_seed(b * 7919 + p)
        tokens = torch.randint(0, cfg.vocab, (b, p), device=dev, generator=gen)
        kl, kc = api.prefill(cfg, params, {"tokens": tokens}, p + g)
        pl, pc = api.prefill(cfg, params, {"tokens": tokens}, p + g, PLAIN)
        variant_rel = {name: _row_rel(api.prefill(cfg, params, {"tokens": tokens}, p + g,
                                                  ks)[0], pl)
                       for name, ks in variants.items()}
        steps = [(kl, pl)]
        tok = kl[:, -1].argmax(dim=-1, keepdim=True)
        for i in range(g - 1):
            kl, kc = api.decode_step(cfg, params, kc, tok, p + i)
            pl, pc = api.decode_step(cfg, params, pc, tok, p + i, PLAIN)
            steps.append((kl, pl))
            tok = kl[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(k).all()) for k, _ in steps):
            raise AssertionError("kernel path logits are not finite")
        rel = torch.stack([_row_rel(k, w) for k, w in steps])  # [steps, batch]
        out.append({
            "batch": b, "prompt": p, "gen": g,
            "row_rel_max": float(rel.max()), "row_rel_prefill_max": float(rel[0].max()),
            "row_rel_median": float(rel.median()),
            "control_prefill_row_rel_min": float(variant_rel["control"].min()),
            "variants_prefill_row_rel_min_median_max": {
                name: [float(r.min()), float(r.median()), float(r.max())]
                for name, r in variant_rel.items()},
            "max_abs_err": max(float((k.float() - w.float()).abs().max()) for k, w in steps),
            "argmax_agree": sum(int((k[:, -1].argmax(-1) == w[:, -1].argmax(-1)).sum())
                                for k, w in steps) / (b * g)})
    sound = max(r["row_rel_max"] for r in out)
    control_min = min(r["control_prefill_row_rel_min"] for r in out)
    emit({"phase": "serve_kernel_vs_plain_path", "requests": out, "limit": SERVE_REL_LIMIT,
          "reading": "per logits row ‖Δ‖₂/‖plain‖₂; variants: the plain path with one "
                     "site changed (control: prefill attention × (1 + 2^-4) past "
                     "position 64)"})
    if sound > SERVE_REL_LIMIT:
        raise AssertionError(f"kernel path off the plain path: {sound} > {SERVE_REL_LIMIT}")
    if control_min <= SERVE_REL_LIMIT:
        raise AssertionError(f"the control passed the parity check ({control_min} ≤ "
                             f"{SERVE_REL_LIMIT}): the check does not discriminate")
    return sound


FLASH_FAULT = 2.0 ** -5  # the flash cells' control: plain o × (1 + 2^-5) past position 64


def flash_cells(cfg, params, dev, requests, extra=None):
    """Every flash cell of ``cfg``'s prefills of ``requests`` (batch,
    prompt, generated tokens) at full width: q, k and v of every attention
    captured on the plain path (self-attention, and the vlm's and whisper's
    non-causal cells: cross-attention, whisper's encoder), then the kernel
    against its plain version on each, held to repro's 0.05 and to
    :func:`flash_bound`. A control, the plain output × (1 + 2^-5) past
    position 64 (rounded to bfloat16), must exceed the bound in every cell.
    ``extra(b)``: the prefill's stand-ins beside the tokens."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ops import to_bkv
    from repro_torch.kernels.flash_attention.ref import attention_plain, flash_bound
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN

    out = []
    for b, p, g in requests:
        captured = []

        def capture(q, k, v, causal):
            captured.append((q, k, v, causal))
            return PLAIN.attention(q, k, v, causal)

        batch = {"tokens": _tokens(cfg, b, p, dev, 23 + b), **(extra(b) if extra else {})}
        api.prefill(cfg, params, batch, p + g, dataclasses.replace(PLAIN, attention=capture))
        shares, faults, kinds = [], [], {}
        while captured:
            q, k, v, causal = captured.pop(0)
            kind = f"{'causal' if causal else 'noncausal'} sq{q.shape[1]} sk{k.shape[1]}"
            kinds[kind] = kinds.get(kind, 0) + 1
            qg, kg, vg = to_bkv(q, k, v)
            got = flash_attention_bkv_cuda(qg, kg, vg, causal=causal)
            torch.cuda.synchronize()
            want = attention_plain(qg, kg, vg, causal=causal)
            _held(got, want, FLASH_TOL[torch.bfloat16] * (1 + want.float().abs()))
            bound = flash_bound(qg, kg, vg, want, causal)
            shares.append(_held(got, want, bound)[1])
            first = min(64, q.shape[1] // 2)  # a cell shorter than 128: past its middle
            bad = want.to(torch.float32)
            bad[:, first:] *= 1.0 + FLASH_FAULT
            bad = bad.to(want.dtype).to(torch.float32)
            faults.append(float(((bad - want.to(torch.float32)).abs() / bound)[:, first:].max()))
            del q, k, v, qg, kg, vg, got, want, bound, bad
        out.append({"batch": b, "prompt": p, "cells": len(shares), "cells_by_kind": kinds,
                    "largest_share_of_bound": max(shares), "share_by_cell": shares,
                    "control_smallest_share": min(faults), "control_share_by_cell": faults})
    emit({"phase": "flash_cells_vs_plain", "arch": cfg.name, "requests": out,
          "cells": sum(r["cells"] for r in out),
          "bound": "bf16 flash 2^-7·|plain| + (2^-8 + Sk·2^-23)·A + 1e-6, A = plain on |v|; and repro's "
                   "0.05·(1 + |plain|)",
          "control": "plain o x (1 + 2^-5) past position 64 must use more than the whole "
                     "bound in every cell"})
    want_cells = step_launches(cfg)[0]["flash_attention"]
    if [r["cells"] for r in out] != [want_cells] * len(requests):
        raise AssertionError(f"captured {[r['cells'] for r in out]} flash cells")
    blind = [r["control_smallest_share"] for r in out if r["control_smallest_share"] <= 1.0]
    if blind:
        raise AssertionError(f"the flash bound does not see a 2^-5 fault: {blind}")
    return out


def one_call(fn) -> dict:
    """Where one call of ``fn`` spends its time: the host clock of a warmed
    call ending in a synchronize, then the card's busy time, idle share,
    device ops (rows with device time: a launch call's row has none) and
    largest kernels from a traced call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    rows = profile_device(fn)
    busy_s = sum(t for t, _ in rows.values()) / 1e6
    seen = busy_s > 0  # else the profiler saw no device activity: not measured
    return {"host_s": host_s, "device_busy_s": busy_s if seen else None,
            "idle_share": 1.0 - busy_s / host_s if seen else None,
            "device_kernels": sum(c for t, c in rows.values() if t > 0),
            "top_device_ops": sorted(([k[:80], t / 1e6, c] for k, (t, c) in rows.items()),
                                     key=lambda x: -x[1])[:8]}


def serve_trace(cfg, params, dev, request=SERVE_REQUESTS[0]):
    """Where serving time goes: host clock of a warm prefill of ``request``
    (batch, prompt, generated tokens) and of one decode step after it,
    untraced; then the card's busy time and its largest kernels from a
    traced run of each. Returns the prefill's reading."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api

    b, p, g = request
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (b, p), device=dev, generator=gen)
    inputs = S._pre_batch(cfg, tokens)
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(cfg, params, inputs, p + g)

    def decode():
        tok = state["logits"][:, -1].argmax(dim=-1, keepdim=True)
        api.decode_step(cfg, params, state["cache"], tok, p)

    row = {"phase": "serve_trace", "arch": cfg.name,
           "what": f"warm prefill b{b} x {p} and one decode step",
           "prefill": one_call(prefill), "decode_step": one_call(decode)}
    emit(row)
    return row["prefill"]


# -- the xLSTM serving path -----------------------------------------------------

XLSTM_ARCH = "xlstm-1.3b"
# (batch, prompt, generated tokens); prompts are multiples of the 128-token
# chunk, as the reference's chunked mLSTM requires.
XLSTM_REQUESTS = ((4, 512, 16), (1, 1024, 8))
XLSTM_PARAMS = 1_716_195_328        # param_count(), as repro computes it
XLSTM_PARAMS_HELD = 2_220_124_160   # what the parameter tensors hold
XLSTM_TEACHER_STEPS = 4
# Float32 copy of the model, kernel path against plain path, per logits row:
# ‖Δ‖₂ / ‖plain‖₂ at most this. It lies near the geometric mean (3.1e-3) of
# the kernel path's largest reading (1.67e-4, 18× below) and the control's
# smallest (0.0558, 18.6× above) (NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6).
XLSTM_F32_REL_LIMIT = 3e-3
# mLSTM cases: name -> (B·H, S, hd, chunk, dtype, inputs). "model": q, v and
# the gates ~ N(0, 1), k ~ N(0, 1/hd), as the projections of a normed
# activation give them; "test": as tests/test_kernels.py draws them (q, k, v
# at scale 0.5, f + 2); "saturated": i = 5, f = −20; "split_stress": the
# bf16 kernel's three-piece split of its float32 operands under a C of wide
# dynamic range: i uniform in [−28, 0] and f = 12 (no decay), so gsrc spans
# about 2^-40 .. 1 (2^±20 about its middle) and C keeps every chunk, and v
# scaled by 2^u, u uniform in −12 .. 11.
MLSTM_CASES = {
    "serve_b4_s512": (16, 512, 1024, 128, torch.bfloat16, "model"),
    "serve_b1_s1024": (4, 1024, 1024, 128, torch.bfloat16, "model"),
    "f32_serve_b4_s512": (16, 512, 1024, 128, torch.float32, "model"),
    "f32_serve_b1_s1024": (4, 1024, 1024, 128, torch.float32, "model"),
    "f32_s128_hd64_c64": (4, 128, 64, 64, torch.float32, "test"),
    "f32_s256_hd64_c128": (4, 256, 64, 128, torch.float32, "test"),
    "f32_s128_hd128_c32": (4, 128, 128, 32, torch.float32, "test"),
    "f32_s64_hd32_c64": (4, 64, 32, 64, torch.float32, "test"),
    "bf16_s100_hd64": (4, 100, 64, 128, torch.bfloat16, "test"),
    "saturated": (1, 128, 32, 64, torch.float32, "saturated"),
    "split_stress": (4, 512, 1024, 128, torch.bfloat16, "split_stress"),
}
FAULT = 2.0 ** -6   # the deliberate fault: y × (1 + FAULT) past position 64


def mlstm_inputs(case, dev, seed=0):
    """q, k, v [B·H, S, hd] in the case's type; i_pre, f_pre [B·H, S] float32."""
    bh, s, hd, _, dtype, kind = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    if kind in ("model", "split_stress"):
        q, k, v = (_randn(gen, (bh, s, hd), f32, dev) for _ in range(3))
        k = k * hd ** -0.5
        i_pre, f_pre = _randn(gen, (bh, s), f32, dev), _randn(gen, (bh, s), f32, dev)
        if kind == "split_stress":
            v = v * torch.exp2(torch.randint(-12, 12, (bh, s, hd), generator=gen,
                                             device=dev).to(f32))
            i_pre = -28.0 * torch.rand((bh, s), generator=gen, device=dev)
            f_pre = torch.full((bh, s), 12.0, device=dev)
    else:
        scale = 1.0 if kind == "saturated" else 0.5
        q, k, v = (_randn(gen, (bh, s, hd), f32, dev, scale) for _ in range(3))
        if kind == "saturated":
            i_pre = torch.full((bh, s), 5.0, device=dev)
            f_pre = torch.full((bh, s), -20.0, device=dev)
        else:
            i_pre = _randn(gen, (bh, s), f32, dev)
            f_pre = _randn(gen, (bh, s), f32, dev) + 2.0
    return q.to(dtype), k.to(dtype), v.to(dtype), i_pre, f_pre


def mlstm_bounds(q, k, v, i_pre, f_pre, y_plain, chunk=128):
    """|Δ| allowed between the mLSTM kernel and its plain version on the
    card: (y, (C, n, m)).

    Both compute one float32 formula; they differ in the order of float32
    sums and in contracted multiply-adds. A sum of n products in any order
    lies within n·2^-24 of the exact sum, relative to the sum of the terms'
    magnitudes, which the plain version run on |q|, |k|, |v| gives (same
    gates). The longest chains: q·C (hd terms) on a state built from sums
    of L terms per chunk plus 2 roundings per chunk carried; W·v (L) on
    q·kᵀ (hd). Two such results differ by at most (hd + L + 4·nc + 32)·
    2^-23 of the magnitudes (32 for exp and the products). exp and log1p
    within 2 ulp move a log-gate cumulated over a chunk by 2^-22·Σ|log f|,
    which scales W, g and gsrc by as much twice: + 2^-21·Σ_chunk|log f|.
    Then y = num / max(|den|, 1): |Δy| ≤ (|Δnum| + |y|·|Δden|) / max(|den|, 1).
    A bfloat16 y adds one output step (2^-7·|y|, 2^-14 for the rounding of
    y_plain). C and n: the same without hd; m: 2^-22·(Σ_S |log f| + |m|)."""
    from repro_torch.kernels.mlstm_chunk.ref import chunk_len, log_sigmoid, mlstm_chunk_terms

    bh, s, hd = q.shape
    L = chunk_len(s, chunk)
    nc = s // L
    num, den, (_, _, m) = mlstm_chunk_terms(q, k, v, i_pre, f_pre, chunk=chunk)
    num_a, den_a, (c_a, n_a, _) = mlstm_chunk_terms(q.abs(), k.abs(), v.abs(), i_pre, f_pre,
                                                    chunk=chunk)
    logf = log_sigmoid(f_pre.to(torch.float32)).abs()
    gate = 2.0 ** -21 * logf.reshape(bh, nc, L).sum(-1).amax(-1)         # [B·H]
    rel_state = (L + 4 * nc + 32) * 2.0 ** -23 + gate
    rel_y = rel_state + hd * 2.0 ** -23
    scale = den.abs().clamp(min=1.0)[..., None]
    y_abs = (num_a + (num / scale).abs() * den_a[..., None]) / scale
    y_bound = rel_y[:, None, None] * y_abs + 1e-30
    if y_plain.dtype == torch.bfloat16:
        y_bound = y_bound + (BF16_STEP + 2.0 ** -14) * y_plain.to(torch.float32).abs()
    return y_bound, (rel_state[:, None, None] * c_a + 1e-30, rel_state[:, None] * n_a + 1e-30,
                     2.0 ** -22 * (logf.sum(-1) + m.abs()) + 1e-30)


def mlstm_pair(args, chunk=128):
    """The kernel and its plain version on the same inputs, held to
    :func:`mlstm_bounds` → ({y, C, n, m: max |Δ|}, {…: share of the bound
    used}, y's bound, kernel y, plain y)."""
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_plain

    got, state = mlstm_chunk_bh_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    want, pstate = mlstm_chunk_plain(*args, chunk=chunk)
    y_bound, state_bounds = mlstm_bounds(*args, want, chunk=chunk)
    err, used = {}, {}
    for name, g, w, lim in zip("yCnm", (got, *state), (want, *pstate), (y_bound, *state_bounds)):
        err[name], used[name] = _held(g, w, lim)
    return err, used, y_bound, got, want


def fault_share(got, want, y_bound) -> float:
    """Largest share of the bound that the kernel's y × (1 + FAULT) past
    position 64 uses: above 1 if the bound can see such a fault."""
    bad = got.to(torch.float32)
    bad[:, 64:] *= 1.0 + FAULT
    bad = bad.to(got.dtype).to(torch.float32)
    return float(((bad - want.to(torch.float32)).abs() / y_bound)[:, 64:].max())


def mlstm_kernel_checks(dev):
    """The mLSTM kernel against its plain version on the card, at both
    serve shapes in bfloat16 and float32, at the reference's test shapes and
    in saturation, each held to :func:`mlstm_bounds`; the bound must see
    the (1 + 2^-6) fault in every case longer than 64."""
    errs, shares, faults = {}, {}, {}
    for name, case in MLSTM_CASES.items():
        args = mlstm_inputs(case, dev)
        errs[name], shares[name], y_bound, got, want = mlstm_pair(args, chunk=case[3])
        if case[1] > 64:
            faults[name] = fault_share(got, want, y_bound)
        del args, y_bound, got, want
    emit({"phase": "mlstm_vs_plain_on_card", "max_abs_err": errs, "share_of_bound_used": shares,
          "fault_share_of_bound": faults,
          "bound": "y: (hd + L + 4·nc + 32)·2^-23 + 2^-21·Σ_chunk|log f| of the plain version "
                   "on |q|,|k|,|v| (divided by max(|den|,1)) [+ (2^-7 + 2^-14)·|y| in bf16]; "
                   "C, n: the same without hd; m: 2^-22·(Σ|log f| + |m|)",
          "fault": "y x (1 + 2^-6) past position 64 must use more than the whole bound"})
    blind = {k: v for k, v in faults.items() if v <= 1.0}
    if blind:
        raise AssertionError(f"the mLSTM bound does not see a 2^-6 fault: {blind}")
    return {name: e["y"] for name, e in errs.items()}


def _tokens(cfg, b, p, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, p), device=dev, generator=gen)


def xlstm_layer_checks(cfg, params, dev):
    """Every mLSTM cell of a b4 × 512 prefill at full width: the inputs of
    all 42 cells captured on the plain path (q, k, v, i, f after the
    projections), then the kernel against its plain version on each, held
    to :func:`mlstm_bounds`."""
    from repro_torch.kernels.mlstm_chunk.ops import fold
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN

    captured = []

    def capture(*args):
        captured.append(args)
        return PLAIN.mlstm(*args)

    b, p, g = XLSTM_REQUESTS[0]
    api.prefill(cfg, params, {"tokens": _tokens(cfg, b, p, dev, 5)}, p + g,
                dataclasses.replace(PLAIN, mlstm=capture))
    shares = []
    while captured:
        args = [fold(t) for t in captured.pop(0)]
        shares.append(mlstm_pair(args)[1])
        del args
    worst = {k: max(s[k] for s in shares) for k in "yCnm"}
    emit({"phase": "xlstm_mlstm_cells_vs_plain", "request": [b, p], "cells": len(shares),
          "largest_share_of_bound": worst, "y_share_by_cell": [s["y"] for s in shares],
          "bound": "as mlstm_vs_plain_on_card"})
    if len(shares) != cfg.n_layers - cfg.n_layers // cfg.slstm_every:
        raise AssertionError(f"captured {len(shares)} mLSTM cells")
    return worst


def _scaled_mlstm(excess: float, first: int):
    """The plain mLSTM cell with its output scaled by 1 + ``excess`` at
    positions from ``first`` on."""
    def mlstm(*args):
        from repro_torch.models.common import PLAIN

        y, state = PLAIN.mlstm(*args)
        y = y.to(torch.float32)
        y[:, first:] *= 1.0 + excess
        return y.to(args[0].dtype), state
    return mlstm


def _teacher_forced(cfg, params, tokens, gen, pairs):
    """Prefill, then ``XLSTM_TEACHER_STEPS`` decode steps, for each kernel
    pair in ``pairs`` (the first one's greedy tokens fed to all) → one list
    of logits per pair, prefill first."""
    from repro_torch.models import api

    p = tokens.shape[1]
    runs = [api.prefill(cfg, params, {"tokens": tokens}, p + gen, ks) for ks in pairs]
    logits = [[lo] for lo, _ in runs]
    caches = [c for _, c in runs]
    tok = logits[0][0][:, -1].argmax(dim=-1, keepdim=True)
    for i in range(XLSTM_TEACHER_STEPS):
        for j, ks in enumerate(pairs):
            lo, caches[j] = api.decode_step(cfg, params, caches[j], tok, p + i, ks)
            logits[j].append(lo)
        tok = logits[0][-1][:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    return logits


def xlstm_bf16_parity(cfg, params, dev):
    """For the record, in bfloat16: the kernel path against the plain path,
    per logits row, and paths that change one site (each kernel alone, the
    mLSTM output scaled). Gated only on finite logits and greedy tokens
    within the vocabulary: bf16 rounding grows through 48 random-weight
    layers as far as a 2^-6 fault does (PERF.md §6)."""
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS, PLAIN

    variants = {
        "rmsnorm_kernel_only": dataclasses.replace(PLAIN, rmsnorm=KERNELS.rmsnorm),
        "mlstm_kernel_only": dataclasses.replace(PLAIN, mlstm=KERNELS.mlstm),
        "mlstm_x(1+2^-6)": dataclasses.replace(PLAIN, mlstm=_scaled_mlstm(FAULT, 0)),
        "mlstm_x(1+2^-6)_past_64": dataclasses.replace(PLAIN, mlstm=_scaled_mlstm(FAULT, 64)),
        "mlstm_x(1+2^-4)_past_64": dataclasses.replace(PLAIN, mlstm=_scaled_mlstm(2.0 ** -4, 64)),
    }
    out = []
    for r, (b, p, g) in enumerate(XLSTM_REQUESTS):
        tokens = _tokens(cfg, b, p, dev, b * 7919 + p)
        kl, pl = _teacher_forced(cfg, params, tokens, g, (KERNELS, PLAIN))
        ok = all(bool(torch.isfinite(t).all()) for t in kl) and all(
            0 <= int(t[:, -1].argmax(-1).min()) and int(t[:, -1].argmax(-1).max()) < cfg.vocab
            for t in kl)
        rel = torch.stack([_row_rel(k, w) for k, w in zip(kl, pl)])  # [steps, batch]
        row = {"batch": b, "prompt": p, "decode_steps": XLSTM_TEACHER_STEPS,
               "row_rel_min_median_max": [float(rel.min()), float(rel.median()),
                                          float(rel.max())],
               "row_rel_prefill": [float(x) for x in rel[0]], "finite_and_in_vocab": ok}
        if r == 0:
            row["variants_prefill_row_rel_min_median_max"] = {}
            for name, ks in variants.items():
                v = _row_rel(api.prefill(cfg, params, {"tokens": tokens}, p + g, ks)[0], pl[0])
                row["variants_prefill_row_rel_min_median_max"][name] = [
                    float(v.min()), float(v.median()), float(v.max())]
        out.append(row)
        if not ok:
            raise AssertionError(f"xlstm kernel path: non-finite logits or tokens: {row}")
    emit({"phase": "xlstm_bf16_kernel_vs_plain_path", "requests": out,
          "reading": "per logits row ‖Δ‖₂/‖plain‖₂, for the record only"})


def xlstm_f32_parity(cfg, params, dev):
    """The kernel path against the plain path in float32, where rounding is
    some 10^4 times smaller than in bfloat16 and a fault is not: a float32
    copy of the same weights (the modules compute in their weights' type),
    prefill b4 × 512 and teacher-forced decode steps, per logits row. The
    control is the plain path with the mLSTM output × (1 + 2^-6) past
    position 64; the limit lies between the two readings."""
    from repro_torch.models.common import KERNELS, PLAIN

    twin = copy.deepcopy(params).float()
    b, p, g = XLSTM_REQUESTS[0]
    tokens = _tokens(cfg, b, p, dev, 17)
    control = dataclasses.replace(PLAIN, mlstm=_scaled_mlstm(FAULT, 64))
    kl, pl, cl = _teacher_forced(cfg, twin, tokens, g, (KERNELS, PLAIN, control))
    del twin
    torch.cuda.empty_cache()
    if kl[0].dtype != torch.float32 or not all(bool(torch.isfinite(t).all()) for t in kl):
        raise AssertionError("float32 kernel path: wrong type or non-finite logits")
    rel = torch.stack([_row_rel(k, w) for k, w in zip(kl, pl)])
    ctl = _row_rel(cl[0], pl[0])
    sound, control_min = float(rel.max()), float(ctl.min())
    emit({"phase": "xlstm_f32_kernel_vs_plain_path", "batch": b, "prompt": p,
          "decode_steps": XLSTM_TEACHER_STEPS, "row_rel_max": sound,
          "row_rel_median": float(rel.median()), "row_rel_by_step": rel.tolist(),
          "control_prefill_row_rel_min": control_min,
          "control_prefill_row_rel": [float(x) for x in ctl],
          "geometric_mean": (sound * control_min) ** 0.5, "limit": XLSTM_F32_REL_LIMIT,
          "reading": "per logits row ‖Δ‖₂/‖plain‖₂; control: plain path with the mLSTM "
                     "output x (1 + 2^-6) past position 64"})
    if sound > XLSTM_F32_REL_LIMIT:
        raise AssertionError(f"float32 kernel path off the plain path: {sound} > "
                             f"{XLSTM_F32_REL_LIMIT}")
    if control_min <= XLSTM_F32_REL_LIMIT:
        raise AssertionError(f"the control passed the float32 check ({control_min} <= "
                             f"{XLSTM_F32_REL_LIMIT}): it does not discriminate")
    return sound, control_min


def mlstm_entry(dev, launches, errs):
    """Times and bounds of the mLSTM kernel at the two prefill shapes; the
    headline numbers are the b4 × 512 request's. ``bound_ms`` counts the
    split products at the bf16 tensor-core rate over three passes, q·kᵀ at
    that rate in one, the rest on the CUDA cores; ``bound_ms_f32_cuda_cores``
    is the earlier figure, every operation at the float32 CUDA-core rate."""
    import re

    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
    from repro_torch.kernels.mlstm_chunk.ops import split_work, work
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_plain

    by_shape = {}
    for name in ("serve_b4_s512", "serve_b1_s1024"):
        case = MLSTM_CASES[name]
        bh, s, hd, chunk, _, _ = case
        args = mlstm_inputs(case, dev)
        fn = lambda: mlstm_chunk_bh_cuda(*args, chunk=chunk)  # noqa: E731
        # each of the three stages runs once per call
        stages = {}
        for k, v in launch_ms(fn, 10, "mlstm_").items():
            short = re.search(r"mlstm_(?:gate|w|state)(?:_f32|_mma)?_kernel", k)
            stages[short.group(0) if short else k[:60]] = v
        ms, how = (sum(t for t, _ in stages.values()), "profiler") if stages else (
            queued_ms(fn, 10), "queued_cuda_events")
        _, nbytes, ops = work(bh, s, hd, chunk, args[0].element_size())
        split, single, cuda = split_work(bh, s, hd, chunk)
        t_ops = (3 * split + single) / PEAK_BF16_PER_S + cuda / PEAK_F32_PER_S
        t_bytes = nbytes / PEAK_BYTES_PER_S
        by_shape[name] = {"shape": [bh, s, hd, chunk], "ops": ops, "bytes": nbytes, "ms": ms,
                          "ms_from": how, "stages_ms": {k: t for k, (t, _) in stages.items()},
                          "stage_launches_seen_of_10": {k: c for k, (_, c) in stages.items()},
                          "wrapper_ms": cuda_ms(fn, 10),
                          "plain_ms": cuda_ms(lambda: mlstm_chunk_plain(*args, chunk=chunk), 3),
                          "bound_ms": max(t_bytes, t_ops) * 1e3,
                          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                          "bound_ops": {"split_3_pass_bf16": split, "bf16_1_pass": single,
                                        "f32_cuda_cores": cuda},
                          "bound_ms_f32_cuda_cores": _bound(nbytes, ops, PEAK_F32_PER_S)[0],
                          "library_ms": None}
        del args
    head = by_shape["serve_b4_s512"]
    return {
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:27",
        "launches": sum(n["mlstm_chunk"] for n in launches.values()),
        "launches_by_path": {path: n["mlstm_chunk"] for path, n in launches.items()},
        # y at the main path's inputs ("model"); split_stress's |y| reaches 2^13
        "max_abs_err": max(e for name, e in errs.items() if MLSTM_CASES[name][5] == "model"),
        "max_abs_err_by_case": errs,
        **{k: head[k] for k in ("ms", "ms_from", "wrapper_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "stages_ms",
                                "bound_ms_f32_cuda_cores")},
        "library_note": "none: no single PyTorch call computes the chunked mLSTM cell",
        "shape": "B·H 16, S 512, hd 1024, L 128, bf16 (b4 x 512 prefill); B·H 4 x 1024 below",
        "by_shape": by_shape,
    }


def _bound(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_sass(lib_path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each flash and mLSTM
    instantiation of the built library, from ``cuobjdump -sass``:
    {"flash": {kernel<hd>: {op: count}}, "mlstm": {kernel: {op: count}}}.
    Raises if the tool is missing or a bfloat16 instantiation has none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found (looked on PATH and in /usr/local/cuda/bin)")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts = {"flash": {}, "mlstm": {}}
    entry = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            f = re.search(r"(flash_(?:mma|f32)_kernel)ILi(\d+)E", head.group(1))
            m = re.search(r"(mlstm_(?:gate|w|state)(?:_f32|_mma)?_kernel)", head.group(1))
            entry = None
            if f:
                entry = counts["flash"].setdefault(f"{f.group(1)}<{f.group(2)}>",
                                                   {"HMMA": 0, "HGMMA": 0})
            elif m:
                entry = counts["mlstm"].setdefault(m.group(1), {"HMMA": 0, "HGMMA": 0})
        elif entry is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                entry[op.group(1)] += 1
    flash_bf16 = {k: v for k, v in counts["flash"].items() if k.startswith("flash_mma_kernel")}
    if len(flash_bf16) != 3 or not all(sum(v.values()) for v in flash_bf16.values()):
        raise AssertionError(f"bf16 flash instantiations without tensor-core SASS: {counts}")
    mlstm_bf16 = {k: v for k, v in counts["mlstm"].items() if k.endswith("_mma_kernel")}
    if sorted(mlstm_bf16) != ["mlstm_state_mma_kernel", "mlstm_w_mma_kernel"] or not all(
            sum(v.values()) for v in mlstm_bf16.values()):
        raise AssertionError(f"bf16 mLSTM kernels without tensor-core SASS: {counts}")
    return counts


def rmsnorm_entry(dev, launches, errs):
    """Times and bounds of the RMSNorm kernel at the serving path's shapes;
    the headline numbers are the [2048, 2560] prefill shape's."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda
    from repro_torch.kernels.rmsnorm.ops import work
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    by_shape = {}
    for name in ("prefill_d2560", "prefill_q_norm", "prefill_k_norm", "decode_d2560",
                 "xlstm_prefill_d2048", "xlstm_prefill_b1_d2048", "xlstm_decode_d2048",
                 "zamba_prefill_d3584", "zamba_shared_cat_d7168"):
        n, d, dtype = RMS_CASES[name]
        x, w = rms_inputs(RMS_CASES[name], dev)
        fn = lambda: rmsnorm_rows_cuda(x, w, 1e-6)  # noqa: E731
        ms, how, seen = kernel_ms(fn, 20, "rmsnorm_")
        # a yardstick only: the port never calls it; its weight is cast to
        # x's type once, outside the timing
        w_lib = w.to(dtype)
        lib = cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-6), 20)
        _, nbytes, ops = work(n, d, x.element_size())
        bound, by = _bound(nbytes, ops, PEAK_F32_PER_S)
        by_shape[name] = {"rows": n, "d": d, "ms": ms, "ms_from": how,
                          "profiled_launches": seen,
                          "wrapper_ms": cuda_ms(fn, 20),
                          "plain_ms": cuda_ms(lambda: rmsnorm_plain(x, w, 1e-6), 20),
                          "bound_ms": bound, "bound_by": by, "library_ms": lib}
    head = by_shape["prefill_d2560"]
    return {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:17",
        "launches": sum(n["rmsnorm"] for n in launches.values()),
        "launches_by_path": {arch: n["rmsnorm"] for arch, n in launches.items()},
        "max_abs_err": max(errs.values()),
        **{k: head[k] for k in ("ms", "ms_from", "wrapper_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "library_call": "torch.nn.functional.rms_norm (weight cast to x's dtype before "
                        "the timing)",
        "shape": "[2048, 2560] bf16 (ln1/ln2 in the b4 x 512 prefill); others below",
        "by_shape": by_shape,
    }


def flash_entry(dev, launches, errs):
    """Times and bounds of the flash kernel at qwen3-4b's two prefill shapes,
    the zoo's non-causal ones (llama-3.2-vision's cross-attention,
    whisper's encoder) and zamba2's shared attention (hd 112, MHA); the
    headline numbers are qwen3-4b's b4 × 512 request's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ops import work
    from repro_torch.kernels.flash_attention.ref import attention_plain

    by_shape = {}
    for name in ("serve_b4_s512", "serve_b1_s1000", "vlm_cross_b4_s512_sk1601",
                 "whisper_encoder_b4_s1500", "zamba_b4_s512_hd112"):
        b, sq, sk, h, kv, hd, causal, _ = FLASH_CASES[name]
        q, k, v = flash_inputs(FLASH_CASES[name], dev)
        fn = lambda: flash_attention_bkv_cuda(q, k, v, causal=causal)  # noqa: E731
        ms, how, seen = kernel_ms(fn, 10, "flash_mma_kernel")
        # the library call takes [B, H, S, hd]; the layout change is made
        # once, outside the timing
        ql = q.reshape(b, kv, sq, h // kv, hd).permute(0, 1, 3, 2, 4).reshape(b, h, sq, hd)
        kl, vl = (t.reshape(b, kv, sk, hd) for t in (k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal, enable_gqa=True), 10)
        # the visible pairs' operations (work().ops), not the plain
        # version's products over every pair (work().flops)
        _, nbytes, flops = work(b, sq, sk, h, kv, hd, causal, q.element_size())
        bound, by = _bound(nbytes, flops, PEAK_BF16_PER_S)
        by_shape[name] = {"shape": [b, sq, sk, h, kv, hd], "flops": flops, "ms": ms,
                          "ms_from": how, "profiled_launches": seen,
                          "wrapper_ms": cuda_ms(fn, 10),
                          "plain_ms": cuda_ms(
                              lambda: attention_plain(q, k, v, causal=causal), 5),
                          "bound_ms": bound, "bound_by": by, "library_ms": lib}
    q, k, v = flash_rows_inputs(dev)
    b, _, sk, h, kv, hd, _, _ = FLASH_CASES[FLASH_ROWS_CASE]
    fn = lambda: flash_attention_bkv_cuda(q, k, v, causal=True, q_start=FLASH_Q_START)  # noqa
    ms, how, seen = kernel_ms(fn, 10, "flash_mma_kernel")
    ql = q.reshape(b, kv, FLASH_ROWS, h // kv, hd).permute(0, 1, 3, 2, 4).reshape(
        b, h, FLASH_ROWS, hd)
    kl, vl = (t.reshape(b, kv, sk, hd) for t in (k, v))
    mask = (torch.arange(FLASH_Q_START, FLASH_Q_START + FLASH_ROWS, device=dev)[:, None]
            >= torch.arange(sk, device=dev)[None, :])
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                         enable_gqa=True), 10)
    _, nbytes, flops = work(b, FLASH_ROWS, sk, h, kv, hd, True, q.element_size(),
                            FLASH_Q_START)
    bound, by = _bound(nbytes, flops, PEAK_BF16_PER_S)
    by_shape[f"{FLASH_ROWS_CASE}_rows_from_{FLASH_Q_START}"] = {
        "shape": [b, FLASH_ROWS, sk, h, kv, hd], "q_start": FLASH_Q_START, "flops": flops,
        "ms": ms, "ms_from": how, "profiled_launches": seen, "wrapper_ms": cuda_ms(fn, 10),
        "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, causal=True,
                                                    q_start=FLASH_Q_START), 5),
        "bound_ms": bound, "bound_by": by, "library_ms": lib,
        "library_call": "scaled_dot_product_attention with the shard's boolean mask"}
    head = by_shape["serve_b4_s512"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "route_note": "bf16 on mma.sync tensor cores (flash_mma_kernel); float32 on the CUDA "
                      "cores (flash_f32_kernel), for checks",
        "launches": sum(n["flash_attention"] for n in launches.values()),
        "launches_by_path": {path: n["flash_attention"] for path, n in launches.items()},
        "max_abs_err": max(errs.values()),
        **{k: head[k] for k in ("ms", "ms_from", "wrapper_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "library_call": "scaled_dot_product_attention(enable_gqa=True), [B, H, S, hd]",
        "shape": "B 4, S 512, H 32, KV 8, hd 128, causal, bf16; b1 x 1000, the vlm cross, "
                 "whisper encoder, zamba2 (hd 112, MHA) and a causal query shard (rows "
                 "384-511 against 512 keys, q_start 384) shapes below",
        "by_shape": by_shape,
    }


# -- the head count's CNN ---------------------------------------------------------

CONV_FRAME = (60, 80)


def conv_frame_check(dev, hc) -> dict:
    """The frame kernel against ``score_frame_window_plain`` on the card at
    every THERMAL window of a seeded random normalized frame, within
    CONV_TOL·max(1, |score|); the control, the plain path one column over,
    must exceed that in CONV_CONTROL_SHARE of the windows. Raises on a
    miss; returns the readings (and, under ``_``-keys, the inputs)."""
    from repro_torch.kernels.conv_window.kernel import conv_window_frame_cuda
    from repro_torch.kernels.conv_window.ops import pack_cnn_weights, window_offsets
    from repro_torch.kernels.conv_window.ref import score_frame_window_plain

    rs = np.random.RandomState(18)
    norm = torch.from_numpy(rs.randint(0, 65536, CONV_FRAME).astype(np.int32)).to(dev)
    packed = pack_cnn_weights(hc.cnn_weights(0), dev)
    wins = [(hc._SCALES[s], y, x) for s in range(3) for y, x in hc._window_coords(hc.THERMAL, s)]
    got = torch.stack([conv_window_frame_cuda(norm, packed, *window_offsets(s, y, x, CONV_FRAME))
                       for s, y, x in wins])
    want = torch.stack([score_frame_window_plain(norm, packed, s, y, x) for s, y, x in wins])
    shifted = torch.stack([score_frame_window_plain(norm, packed, s, y, x + 1)
                           for s, y, x in wins])
    torch.cuda.synchronize()
    share = (got - want).abs() / (CONV_TOL * torch.clamp(want.abs(), min=1.0))
    ctl = (got - shifted).abs() / (CONV_TOL * torch.clamp(shifted.abs(), min=1.0))
    out = {"frame_windows": len(wins), "frame_max_abs_err": (got - want).abs().max().item(),
           "frame_max_share_of_tol": share.max().item(),
           "control_share_of_windows_over_tol": (ctl > 1).float().mean().item(),
           "control_median_share_of_tol": ctl.median().item()}
    if not bool(torch.isfinite(got).all()) or bool((share > 1).any()):
        raise AssertionError(f"frame kernel off its plain version: {out}")
    if out["control_share_of_windows_over_tol"] < CONV_CONTROL_SHARE:
        raise AssertionError(f"the shifted-window control passes the tolerance: {out}")
    return {**out, "_norm": norm, "_packed": packed}


def host_ms(fn, reps: int = 200, rounds: int = 5) -> list:
    """[least, median] milliseconds per call of ``fn`` over ``rounds`` runs
    of ``reps`` back-to-back calls (CUDA events): host-bound calls read the
    host's pace."""
    xs = sorted(cuda_ms(fn, reps) for _ in range(rounds))
    return [xs[0], xs[len(xs) // 2]]


def conv_frame_host_parts(dev, lib, norm, packed, offsets) -> dict:
    """The frame wrapper's host path and its parts, [least, median] ms per
    call: the whole wrapper, its output allocation, the stream handle (the
    raw one it takes, and the ``Stream`` object it avoids), the current-card
    query, the three ``data_ptr`` reads and the bare ctypes launch."""
    from repro_torch.kernels.conv_window.kernel import _raw_stream, conv_window_frame_cuda

    out = torch.empty((), dtype=torch.float32, device=dev)
    args = (norm.data_ptr(), packed.data_ptr(), out.data_ptr(), *offsets)
    stream = _raw_stream(dev.index)
    return {
        "wrapper": host_ms(lambda: conv_window_frame_cuda(norm, packed, *offsets)),
        "torch_empty_0d": host_ms(lambda: torch.empty((), dtype=torch.float32, device=dev)),
        "raw_stream": host_ms(lambda: _raw_stream(dev.index)),
        "current_stream_object": host_ms(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "current_device": host_ms(torch.cuda.current_device),
        "data_ptr_x3": host_ms(lambda: (norm.data_ptr(), packed.data_ptr(), out.data_ptr())),
        "ctypes_launch": host_ms(lambda: lib.conv_window_frame_launch(*args, stream)),
    }


def conv_window_entry(dev, lib, launches, frame, windows, wl, batch_err) -> dict:
    """The kernels line's CNN entry: the frame kernel at one window (the main
    path, N=1) beside an empty one-block launch of the same library, then
    the batch kernel at each N of CONV_BATCHES."""
    from repro_torch.kernels.conv_window.kernel import (_raw_stream, conv_window_frame_cuda,
                                                        conv_window_scores_cuda)
    from repro_torch.kernels.conv_window.ops import window_offsets
    from repro_torch.kernels.conv_window.ref import (conv_window_scores_plain,
                                                     score_frame_window_plain)

    def bound(nbytes, n):
        ops = n * 2 * (10 * 10 * 8 * 9 + 3 * 3 * 16 * 72 + 16)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
        return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    norm, packed = frame["_norm"], frame["_packed"]
    scale, y, x = 2, 9, 14
    offsets = window_offsets(scale, y, x, CONV_FRAME)
    fn = lambda: conv_window_frame_cuda(norm, packed, *offsets)  # noqa: E731
    ms, how, seen = kernel_ms(fn, 20, "conv_window_frame_kernel")
    empty = lambda: lib.repro_empty_launch(576, _raw_stream(dev.index))  # noqa: E731
    floor_ms, _, floor_seen = kernel_ms(empty, 20, "repro_empty_kernel")
    bound_ms, by = bound(144 * 4 + 1265 * 4 + 4, 1)
    batch = {}
    for n, xs in windows.items():
        bfn = lambda: conv_window_scores_cuda(xs, *wl)  # noqa: E731
        bms, bhow, bseen = kernel_ms(bfn, 20, "conv_window_batch_kernel")
        b_bound, b_by = bound(n * 144 * 4 + 1265 * 4 + n * 4, n)
        batch[n] = {"ms": bms, "ms_from": bhow, "profiled_launches": bseen,
                    "wrapper_ms": cuda_ms(bfn, 20),
                    "plain_ms": cuda_ms(lambda: conv_window_scores_plain(xs, *wl), 20),
                    "bound_ms": b_bound, "bound_by": b_by, "share_of_bound": b_bound / bms,
                    "max_abs_err": batch_err[n]}
    return {
        "name": "conv_window", "route": "cuda",
        "source": "src/repro_torch/kernels/conv_window/csrc/conv_window.cu",
        "replaces": "src/repro/kernels/conv_window/kernel.py:37",
        "launches": launches, "max_abs_err": frame["frame_max_abs_err"],
        "ms": ms, "ms_from": how, "profiled_launches": seen,
        "empty_launch_floor_ms": floor_ms, "empty_launch_profiled": floor_seen,
        "wrapper_ms": cuda_ms(fn, 200),
        "plain_ms": cuda_ms(lambda: score_frame_window_plain(norm, packed, scale, y, x), 20),
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes the fused CNN",
        "shape": ("N=1: conv_window_frame_kernel, one THERMAL window read from the "
                  "normalized 60x80 frame per launch (the main path); batch below"),
        "wrapper_host_parts_ms_least_median": conv_frame_host_parts(dev, lib, norm, packed,
                                                                    offsets),
        "batch_5452": batch[5452],
        "batch_other_n": {n: v for n, v in batch.items() if n != 5452},
    }


# -- the decode graph, planned serving and traffic ---------------------------------

# Planned serving: arch -> ((batch, prompt, generated tokens), decode steps a
# cycle may hold, the cycle after whose execution a power failure strikes or
# None). The budget is e_startup + steps · e_total: qwen3-4b's 16 tokens take
# cycles of 5, 5, 5, 1 steps, xlstm-1.3b's 8 (max_seq 520, the table's 1×1024
# bucket; b1 keeps its 0.7 GB state packets small on the host) 3, 3, 2.
PLANNED = {SERVE_ARCH: ((4, 512, 16), 5, 1), XLSTM_ARCH: ((1, 512, 8), 3, None)}
# The traffic harness: 3 arrivals at virtual time 0 of this shape, a harvest
# pool of 1.5 requests' energy replenished at 0.9 a unit of virtual time
# (tests/test_traffic.py's real-model run, here at full width).
TRAFFIC_SHAPE = (1, 128, 8)
TRAFFIC_ARRIVALS = 3


def serving_launches() -> dict:
    """The serving kernels' launch counts."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda

    return {"rmsnorm": rmsnorm_rows_cuda, "flash_attention": flash_attention_bkv_cuda,
            "mlstm_chunk": mlstm_chunk_bh_cuda}


def step_launches(cfg) -> tuple:
    """({kernel: launches} of one prefill, of one decode step) of ``cfg``:
    one RMSNorm launch per norm site (a step's and a prefill's alike: ln1,
    ln2, q- and k-norm of a self layer, the norm of a vlm cross layer, a
    Mamba2 block's norm, the shared block's 2d and MLP norms, the final
    norm; whisper's LayerNorms are plain), one flash launch per attention a
    prefill (whisper: encoder, decoder self and cross; zamba2: each shared
    application), or one mLSTM launch per mLSTM block a prefill."""
    if cfg.family == "ssm":
        norms = cfg.n_layers + 1
        pre = {"flash_attention": 0,
               "mlstm_chunk": cfg.n_layers - cfg.n_layers // cfg.slstm_every}
    elif cfg.family == "hybrid":  # a norm per Mamba2 block, two per shared application
        n_groups = cfg.n_layers // cfg.attn_every
        norms = cfg.n_layers + 2 * n_groups + 1
        pre = {"flash_attention": n_groups, "mlstm_chunk": 0}
    elif cfg.family == "encdec":
        norms = 0
        pre = {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers, "mlstm_chunk": 0}
    else:
        n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" else 0
        n_self = cfg.n_layers - n_cross
        norms = (4 if cfg.qk_norm else 2) * n_self + n_cross + 1
        pre = {"flash_attention": n_self + n_cross, "mlstm_chunk": 0}
    return ({"rmsnorm": norms, **pre},
            {"rmsnorm": norms, "flash_attention": 0, "mlstm_chunk": 0})


def serve_step_graphs(cfg, params, dev, request):
    """The unplanned path's graphed decode (``_step_fns``, captured by
    serve_path) against the eager masked decode on one request in one
    process: the eager path is fed the graph path's tokens; each step's
    logits must be bitwise equal and argmax to the same token. Two requests
    through the graph add no capture. Prints decode ms/token (host clock)
    and one step of each path (host clock, the card's busy time, idle
    share)."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api

    b, p, g = request
    prompts = S._prompts(cfg, b, p, 0, dev)
    inputs = S._pre_batch(cfg, prompts)
    prefill, decode = S._step_fns(cfg.name, False, b, p + g, dev, donate=True)
    trace0 = dict(S.TRACE_COUNT)

    def graphed():
        logits, cache = prefill(params, inputs)
        toks, steps = [S._argmax_token(logits)], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(g - 1):
            logits, cache = decode(params, cache, toks[-1], p + i)
            toks.append(S._argmax_token(logits))
            steps.append(logits)
        torch.cuda.synchronize()
        return torch.cat(toks, dim=1), steps, (time.perf_counter() - t0) / (g - 1), cache

    toks, g_steps, g_s, g_cache = graphed()
    toks2, _, g2_s, _ = graphed()
    captures = {k: S.TRACE_COUNT[k] - trace0[k] for k in trace0}

    logits, cache = api.prefill(cfg, params, inputs, p + g)
    e_steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(g - 1):
        logits, cache = api.decode_step(cfg, params, cache, toks[:, i:i + 1], p + i)
        e_steps.append(logits)
    torch.cuda.synchronize()
    e_s = (time.perf_counter() - t0) / (g - 1)
    n_bitwise = sum(bool(torch.equal(a, e)) for a, e in zip(g_steps, e_steps))
    diffs = [float((a.float() - e.float()).abs().max()) for a, e in zip(g_steps, e_steps)]
    same_tokens = all(bool(torch.equal(S._argmax_token(e), toks[:, i + 1:i + 2]))
                      for i, e in enumerate(e_steps))
    row = {"phase": "serve_step_graphs", "arch": cfg.name,
           "request": {"batch": b, "prompt": p, "gen": g},
           "steps": g - 1, "bitwise_equal_steps": n_bitwise, "max_abs_diff": max(diffs),
           "tokens_equal_eager": same_tokens,
           "second_request_tokens_equal": bool(torch.equal(toks, toks2)),
           "captures_over_both_requests": captures,
           "graph_decode_ms_per_token": [g_s * 1e3, g2_s * 1e3],
           "eager_decode_ms_per_token": e_s * 1e3,
           "graph_step": one_call(lambda: decode(params, g_cache, toks[:, -1:], p + g - 1)),
           "eager_step": one_call(lambda: api.decode_step(cfg, params, cache, toks[:, -1:],
                                                           p + g - 1))}
    emit(row)
    ok = (same_tokens and row["second_request_tokens_equal"] and not any(captures.values())
          and n_bitwise == g - 1)
    if not ok:
        raise AssertionError(f"{cfg.name}: graphed decode check failed")
    return row


def serve_prefill_graphs(cfg, params, dev, requests, eager, extra=None):
    """The graphed prefill (``_step_fns`` on a card, one graph per request
    shape captured by serve_path) against the eager prefill on new inputs
    of the first request's shape (seeded tokens, and ``extra(b)``'s random
    stand-ins with the vlm cross gates at ZOO_GATE): the logits and every
    cache leaf bitwise, counted with the largest difference; two requests
    through the graph equal and adding no capture. Prints each capture of
    the path (recording and instantiation seconds, the private pool's
    bytes, the launches a replay adds) and the warm graphed prefill's host
    clock, busy time and idle share (:func:`one_call`) beside ``eager``,
    :func:`serve_trace`'s reading of the eager prefill at the same shape in
    this process."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api

    b, p, g = requests[0]
    inputs = S._pre_batch(cfg, _tokens(cfg, b, p, dev, 61))
    if extra is not None:
        inputs.update(extra(b))
    prefill = S._step_fns(cfg.name, False, b, p + g, dev, donate=True)[0]
    with cross_gates(params, ZOO_GATE if extra else None):
        trace0 = dict(S.TRACE_COUNT)
        first, second = (prefill(params, inputs) for _ in range(2))
        captures = {k: S.TRACE_COUNT[k] - trace0[k] for k in trace0}
        want = api.prefill(cfg, params, inputs, p + g)
        torch.cuda.synchronize()
    pairs = [(first[0], want[0])] + list(zip(S._leaves(first[1]), S._leaves(want[1])))
    n_equal = sum(bool(torch.equal(a, w)) for a, w in pairs)
    diff = max(float((a.float() - w.float()).abs().max()) for a, w in pairs)
    repeat = all(bool(torch.equal(a, c)) for a, c in zip(
        [first[0], *S._leaves(first[1])], [second[0], *S._leaves(second[1])]))
    del first, second, want
    graphs = []
    for rb, rp, rg in requests:
        for key, cap in S._step_fns(cfg.name, False, rb, rp + rg, dev,
                                    donate=True)[0].graphs(params).items():
            graphs.append({"inputs": {k: list(shape) for k, shape, _ in key}, **cap.stats,
                           "launches_a_replay": {fn.__name__: n for fn, n in cap.launches}})
    shapes = len({(rb, rp, rp + rg) for rb, rp, rg in requests})
    row = {"phase": "serve_prefill_graphs", "arch": cfg.name,
           "request": {"batch": b, "prompt": p, "gen": g},
           "inputs": "seeded tokens" + (", random stand-ins, cross gates 0.5"
                                         if extra is not None else ""),
           "leaves": len(pairs), "bitwise_equal_leaves": n_equal, "max_abs_diff": diff,
           "second_request_equal": repeat, "captures_over_both_requests": captures,
           "captures_over_the_path": len(graphs), "request_shapes": shapes,
           "graphs": graphs,
           "graphed": one_call(lambda: prefill(params, inputs)),
           "eager": {k: v for k, v in eager.items() if k != "top_device_ops"}}
    emit(row)
    ok = (n_equal == len(pairs) and repeat and not any(captures.values())
          and len(graphs) == shapes)
    if not ok:
        raise AssertionError(f"{cfg.name}: graphed prefill check failed")
    return row


def serve_planned(cfg, params, dev, table, request, per_cycle, crash_after):
    """The planned path at full width on ``table`` (built on the sweep
    kernel by the plan_table phase): warmed once, then one request under a
    budget of e_startup + ``per_cycle`` · e_total with, if ``crash_after``
    is a cycle index, one power failure after that cycle executed. Tokens
    must equal the unplanned ``serve``'s; commits equal the cycles, one
    replay per power failure; no build or capture, no sweep launch (no
    solve), every lookup a hit; the serving kernels launch as the tasks run
    say. Prints planned and unplanned seconds, the NVM bytes and the time of
    one state packet's store and load and of the decode's copies into and
    out of the graph. Returns the kernels' launches in the planned run."""
    from repro_torch.core.runtime import (COMMIT_STATS, MemoryNVM, PowerFailure, _to_device,
                                          _to_host)
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import serve as S
    from repro_torch.launch.planner import ServePlanner, request_cycles

    b, p, g = request
    planner = ServePlanner(table)
    plan = table.lookup(b, p + g, None)
    budget = table.e_startup + per_cycle * plan.e_total
    S.PlannedExecutor(cfg.name, planner, device=dev, params={(0, p + g): params}).warmup(
        [(b, p, g, 0)], cycle_budget=budget)
    S.serve(cfg.name, b, p, g, smoke=False, device=dev, params=params)  # warms the unplanned key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = S.serve(cfg.name, b, p, g, smoke=False, device=dev, params=params)
    unplanned_s = time.perf_counter() - t0

    fired = []

    def crash(bi, phase):
        if bi == crash_after and phase == "executed" and not fired:
            fired.append(bi)
            raise PowerFailure(f"injected after cycle {bi} executed")

    counters = serving_launches()
    for fn in counters.values():
        fn.launches = 0
    sweeps0, trace0, commit0 = sweep_columns_cuda.launches, dict(S.TRACE_COUNT), dict(COMMIT_STATS)
    planner.reset_stats()
    rep = {}
    got = S.serve(cfg.name, b, p, g, smoke=False, device=dev, params=params, plan_table=planner,
                  energy_budget=budget, nvm=MemoryNVM(), crash_hook=crash, report=rep)
    launches = {name: fn.launches for name, fn in counters.items()}
    cycles = request_cycles(g, plan.e_total, budget, e_startup=table.e_startup)
    stats, nvm = rep["runtime_stats"], rep["nvm"]
    runs = [k for i, j in cycles for k in range(i, j + 1)]
    if fired:
        i, j = cycles[crash_after]
        runs += range(i, j + 1)
    pre, step = step_launches(cfg)
    want_launches = {k: pre[k] * runs.count(1) + step[k] * (len(runs) - runs.count(1))
                     for k in pre}
    commits = {k: COMMIT_STATS[k] - commit0[k] for k in commit0}

    # one state packet's NVM store and load, and the decode's copy into the
    # graph's static inputs and out of it
    name = f"state{cycles[-2][1] - 1}"  # task k writes state k-1; the last one stored
    host = nvm.read(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = _to_device(host, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _to_host(state)
    store_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in S._leaves(state["cache"]))
    decode = S._step_fns(cfg.name, False, b, p + g, dev, donate=False)[1]
    (cap,) = decode.graphs(params).values()
    feed_ms = cuda_ms(lambda: cap.feed({"cache": state["cache"], "tok": state["tok"],
                                        "pos": p}), 5)
    clone_ms = cuda_ms(lambda: S._map(torch.clone, cap.inputs["cache"]), 5)
    del state
    row = {"phase": "serve_planned", "arch": cfg.name,
           "request": {"batch": b, "prompt": p, "gen": g}, "budget": budget,
           "steps_per_cycle": per_cycle, "cycles": rep["cycles"],
           "power_failures": len(fired), "commits": commits,
           "bursts_run": stats.bursts_run, "tasks_run": stats.tasks_run,
           "tokens_equal_unplanned": bool(torch.equal(got, want)),
           "trace_count_delta": {k: S.TRACE_COUNT[k] - trace0[k] for k in trace0},
           "sweep_launches": sweep_columns_cuda.launches - sweeps0,
           "planner_stats": {k: v for k, v in rep["planner_stats"].items() if k != "by_bucket"},
           "launches": launches, "expected_launches": want_launches,
           "planned_s": rep["seconds"], "unplanned_s": unplanned_s,
           "nvm_bytes_stored": stats.bytes_stored, "nvm_bytes_loaded": stats.bytes_loaded,
           "state_packet": name, "state_cache_bytes": cache_bytes,
           "state_store_ms": store_s * 1e3, "state_load_ms": load_s * 1e3,
           "state_store_gb_s": cache_bytes / store_s / 1e9,
           "state_load_gb_s": cache_bytes / load_s / 1e9,
           "decode_copy_in_ms": feed_ms, "decode_copy_out_ms": clone_ms}
    emit(row)
    ps = row["planner_stats"]
    ok = (row["tokens_equal_unplanned"] and rep["cycles"] == cycles
          and stats.bursts_run == len(cycles) == commits["commits"]
          and commits["replays"] == stats.replays == len(fired)
          and len(fired) == (crash_after is not None)
          and not any(row["trace_count_delta"].values()) and row["sweep_launches"] == 0
          and ps["lookups"] == ps["hits"] == 1 and ps["misses"] == 0
          and launches == want_launches)
    if not ok:
        raise AssertionError(f"{cfg.name}: planned serving check failed")
    return launches


def traffic_path(cfg, params, dev, table):
    """The traffic harness over qwen3-4b's PlannedExecutor at full width:
    TRAFFIC_ARRIVALS arrivals of TRAFFIC_SHAPE at virtual time 0 against a
    pool of 1.5 requests' tabulated energy replenished at 0.9 a unit. All
    admitted and completed, at least one deferred, no build or capture
    after the warm-up, every lookup a hit, tokens equal to the unplanned
    ``serve``'s. Prints requests/s and latency percentiles; returns the
    kernels' launches in the run."""
    from repro_torch.launch import serve as S
    from repro_torch.launch.traffic import (HarvestModel, TrafficHarness,
                                            deterministic_arrivals, request_energy)

    b, p, g = TRAFFIC_SHAPE
    ex = S.PlannedExecutor(cfg.name, table, device=dev, params={(0, p + g): params})
    plan = ex.planner.plan_for(b, p + g, None)
    _, e_req = request_energy(plan, g, None, ex.planner.e_startup)
    harness = TrafficHarness(ex, harvest=HarvestModel(capacity=1.5 * e_req, rate=0.9 * e_req),
                             keep_tokens=True)
    reqs = deterministic_arrivals(TRAFFIC_ARRIVALS, 0.0, (b, p, g))
    harness.warmup(reqs)
    want = S.serve(cfg.name, b, p, g, smoke=False, device=dev, params=params).numpy()
    counters = serving_launches()
    for fn in counters.values():
        fn.launches = 0
    report = harness.run(reqs)
    launches = {name: fn.launches for name, fn in counters.items()}
    pre, step = step_launches(cfg)
    n = TRAFFIC_ARRIVALS
    want_launches = {k: n * (pre[k] + (g - 1) * step[k]) for k in pre}
    row = {"phase": "traffic", "arch": cfg.name, "shape": list(TRAFFIC_SHAPE),
           "arrivals": n, "e_req": e_req, "summary": report.summary(),
           "admitted": report.admitted, "completed": report.completed,
           "deferred": report.deferred, "rejected": report.rejected,
           "trace_delta": report.trace_delta, "hit_rate": report.hit_rate,
           "commit_delta": report.commit_delta, "wall_s": report.wall_seconds,
           "requests_per_s": report.requests_per_s,
           "latency_ms": report.latency_percentiles_ms(),
           "ledger_conserved": report.ledger_conserved,
           "tokens_equal_unplanned": all(np.array_equal(report.tokens[r], want)
                                         for r in range(n)),
           "launches": launches, "expected_launches": want_launches}
    emit(row)
    ok = (report.admitted == report.completed == n and report.deferred >= 1
          and not any(report.trace_delta.values()) and report.hit_rate == 1.0
          and row["tokens_equal_unplanned"] and report.ledger_conserved
          and launches == want_launches)
    if not ok:
        raise AssertionError("traffic check failed")
    return launches, report


CALIBRATION_DRIFT_TOL = 0.05   # the serve and traffic CLIs' default
CALIBRATION_NOISE = 0.01       # relative jitter of the noisy profile's restore rows
CALIBRATION_CONFIDENCE = 0.9


def calibration_loop(cfg, built, ledger, dev) -> int:
    """The paper's loop closed on the card: the traffic run's ledger → a
    measured cost table; a replan on the sweep kernel through the traffic
    module's ``replan`` (byte-identical to the plan_table phase's time
    table); a probe of every cell against the measured profile (passes);
    the restore rows scaled past the drift tolerance (refused) and inside
    it (passes); a noisy profile solved at ``confidence=0.9`` through the
    façade on the kernel, bitwise equal to the numpy backend under the same
    priced model, then probed by the serve module's ``calibration_probe``.
    Returns the sweep launches of the phase."""
    from repro_torch.api import PartitionSpec, solve
    from repro_torch.core.calibration import MeasuredCostTable
    from repro_torch.core.plan_table import StaleTableError, probe_plan_table
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import serve as S
    from repro_torch.launch.planner import lower_buckets
    from repro_torch.launch.traffic import replan

    tol = CALIBRATION_DRIFT_TOL
    t = next(t for t in built if t["arch"] == cfg.name and t["kind"] == "time")
    table = t["table"]
    sweep_columns_cuda.launches = 0
    t0 = time.perf_counter()
    measured = MeasuredCostTable.from_ledger(ledger, kind="time")
    rows = ledger.sorted_rows()

    def profile(scale_restore=1.0, noise=0.0):
        rng = np.random.default_rng(0)
        out = MeasuredCostTable(measured.base, "time")
        for r in rows:
            e = r["energy"]
            if r["category"] == "restore":
                e = e * scale_restore * (1.0 + noise * rng.standard_normal())
            elif r["category"] == "commit" and noise:
                e = e * (1.0 + 5 * noise * rng.standard_normal())
            out.add(r["category"], e)
        return out

    l0 = sweep_columns_cuda.launches
    res = replan(table, cfg, measured, backend="cuda", drift_tol=tol, k=4)
    replan_launches = sweep_columns_cuda.launches - l0
    l0, t1 = sweep_columns_cuda.launches, time.perf_counter()
    probed = probe_plan_table(table, cfg, k=None, backend="cuda", measured=measured,
                              drift_tol=tol)
    probe_s, probe_launches = time.perf_counter() - t1, sweep_columns_cuda.launches - l0

    # a restore scale that moves the table's smallest cycle by twice the
    # tolerance must be refused; one that moves it by half must pass
    e_s, e_min = float(measured.base.e_startup), float(table.cycle_energy.min())
    f_out = 1.0 + 2.0 * tol * e_min / ((1.0 - tol) * e_s)
    f_in = 1.0 + 0.5 * tol * e_min / e_s
    try:
        probe_plan_table(table, cfg, k=None, backend="cuda", measured=profile(f_out),
                         drift_tol=tol)
        refused = None
    except StaleTableError as exc:
        refused = str(exc)[:160]
    passed_in = probe_plan_table(table, cfg, k=None, backend="cuda",
                                 measured=profile(f_in), drift_tol=tol)

    noisy = profile(noise=CALIBRATION_NOISE)
    graphs = lower_buckets(cfg, table.buckets(), "time")
    spec = dict(graphs=tuple(graphs), cost=noisy, confidence=CALIBRATION_CONFIDENCE,
                q_grid=tuple(table.q_values()))
    l0, t1 = sweep_columns_cuda.launches, time.perf_counter()
    got = solve(PartitionSpec(backend="cuda", **spec))
    conf_s, conf_launches = time.perf_counter() - t1, sweep_columns_cuda.launches - l0
    want = solve(PartitionSpec(backend="numpy", **spec))
    conf_equal = got.cost == want.cost and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(got.sweeps, want.sweeps)
        for f in ("dp", "parent", "e_total", "feasible", "starts"))
    l0, t1 = sweep_columns_cuda.launches, time.perf_counter()
    served_probe = S.calibration_probe(table, cfg.name, noisy, smoke=False, device=dev,
                                       drift_tol=tol, k=None)
    serve_probe_s = time.perf_counter() - t1
    serve_probe_launches = sweep_columns_cuda.launches - l0
    launches = sweep_columns_cuda.launches
    restore = noisy.stats["restore"]
    row = {"phase": "calibration_loop", "arch": cfg.name, "table": table.summary(),
           "ledger_samples": measured.n_samples,
           "fingerprint": measured.fingerprint()[:16],
           "restore_mean": measured.stats["restore"].mean,
           "restore_std": measured.stats["restore"].std,
           "cost_model_is_base": measured.cost_model() is measured.base,
           "replan_identical": res.identical, "replan_probed": res.probed,
           "replan_stale": res.stale, "replan_build_s": res.build_s,
           "replan_probe_s": res.probe_s, "replan_launches": replan_launches,
           "probe_cells": probed, "probe_s": probe_s, "probe_launches": probe_launches,
           "drift_tol": tol, "smallest_cycle": e_min, "e_startup": e_s,
           "restore_factor_refused": f_out, "refused": refused,
           "restore_factor_passed": f_in, "passed_cells": passed_in,
           "confidence": CALIBRATION_CONFIDENCE,
           "noisy_restore_mean": restore.mean, "noisy_restore_std": restore.std,
           "priced_e_startup": got.cost.e_startup,
           "priced_transfer_scale": noisy.transfer_scale(CALIBRATION_CONFIDENCE),
           "confidence_bitwise_equal_numpy": conf_equal, "confidence_solve_s": conf_s,
           "confidence_launches": conf_launches, "serve_probe_cells": served_probe,
           "serve_probe_s": serve_probe_s, "serve_probe_launches": serve_probe_launches,
           "seconds": time.perf_counter() - t0, "sweep_launches": launches}
    emit(row)
    ok = (row["cost_model_is_base"] and res.identical and res.stale is None
          and res.probed == 4 and probed == table.feasible.size and refused is not None
          and "drifted" in refused and passed_in == probed and conf_equal
          and got.cost.e_startup > restore.mean and served_probe == probed
          and launches > 0)
    if not ok:
        raise AssertionError("calibration loop check failed")
    return launches


def dense_engine(built, g_thermal, cm_thermal) -> dict:
    """The dense sweep (``scan``) on the card: each plan_table-phase table
    rebuilt on it in one batched pass, byte-equal to the kernel's build;
    both engines timed side by side (least of two builds each, from the
    same lowered graphs); the dense export's bytes per bucket and of the
    full THERMAL head count, which ``auto`` must leave on the kernel; and
    the device kernels of one dense solve (every float64 op its own
    elementwise launch)."""
    from repro_torch.api import PartitionSpec, solve
    from repro_torch.core.engine import resolve_auto_backend
    from repro_torch.core.graph import dense_export_nbytes
    from repro_torch.core.plan_table import PlanTable, build_plan_table
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch.planner import lower_buckets

    def nbytes(g):
        return dense_export_nbytes(g.n_tasks, max((len(t.reads) for t in g.tasks), default=0),
                                   max((len(t.writes) for t in g.tasks), default=0))

    rows = []
    for t in built:
        cfg, cm, qs, ref = t["cfg"], t["cost"], t["qs"], t["table"]
        graphs = lower_buckets(cfg, ref.buckets(), t["kind"])
        secs = {"scan": [], "cuda": []}
        tables = {}
        for backend in ("scan", "cuda", "scan", "cuda"):
            l0 = sweep_columns_cuda.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tables[backend] = build_plan_table(cfg, ref.buckets(), qs, kind=t["kind"],
                                               cost=cm, graphs=graphs, backend=backend)
            torch.cuda.synchronize()
            secs[backend].append(time.perf_counter() - t0)
            if backend == "scan" and sweep_columns_cuda.launches != l0:
                raise AssertionError("the scan build launched the sweep kernel")
        scan = tables["scan"]
        equal = (scan.content_digest() == ref.content_digest()
                 and all(np.array_equal(getattr(scan, n), getattr(ref, n))
                         for n in PlanTable._PAYLOAD))
        rows.append({"arch": t["arch"], "kind": t["kind"], "buckets": len(graphs),
                     "q_points": len(qs), "tasks": [g.n_tasks for g in graphs],
                     "scan_build_s": secs["scan"], "cuda_build_s": secs["cuda"],
                     "scan_over_cuda": min(secs["scan"]) / min(secs["cuda"]),
                     "byte_equal_kernel_build": equal,
                     "dense_export_bytes": [nbytes(g) for g in graphs],
                     "csr_export_bytes": [g.to_csr_arrays().nbytes for g in graphs]})
        if not equal:
            raise AssertionError(f"dense-engine table != kernel build: {rows[-1]}")
    g0 = lower_buckets(built[0]["cfg"], built[0]["table"].buckets()[:1], built[0]["kind"])[0]
    spec = PartitionSpec(graph=g0, cost=built[0]["cost"], q_grid=tuple(built[0]["qs"]),
                         backend="scan")
    solve(spec)
    kernels = profile_device(lambda: solve(spec))
    launched = {k[:96]: c for k, (us, c) in kernels.items() if us > 0}
    fused = sorted(k for k in launched if any(w in k.lower() for w in ("addcmul", "fma", "lerp")))
    thermal_auto = resolve_auto_backend(g_thermal)
    row = {"phase": "dense_engine", "tables": rows,
           "thermal_dense_export_bytes": nbytes(g_thermal),
           "thermal_csr_export_bytes": g_thermal.to_csr_arrays().nbytes,
           "thermal_auto_backend": thermal_auto,
           "thermal_auto_backend_via_facade": solve(PartitionSpec(
               graph=g_thermal, cost=cm_thermal, objective="minimax")).backend,
           "one_solve": {"tasks": g0.n_tasks, "device_launches": sum(launched.values()),
                         "launches_per_column": sum(launched.values()) / g0.n_tasks,
                         "kernels": sorted(launched.items(), key=lambda kv: -kv[1])[:8],
                         "fused_multiply_add_kernels": fused}}
    emit(row)
    if thermal_auto != "cuda" or row["thermal_auto_backend_via_facade"] != "cuda" or fused:
        raise AssertionError(f"dense engine check failed: {row}")
    return row


# The swarm path: the swarm CLI on each case with 3 nodes (the chain: 4) of
# these compute scales, the default 25 links (900:3400:100 mbps) and these
# Q and memory scales: 225 grid points. Each node's NVM is the whole graph's
# span footprint, so that the memory axis's 0.5 refuses some cells. At the
# base Q scale (0.8 of Q_min × 1.25) only node 0 (compute scale 1) can run a
# burst, so the base cell, which decides the CLI's exit code, is feasible
# only where one node holds the whole footprint: the base memory scale is 1.
SWARM_ARCHS = (("qwen3-4b", "4x512"), ("xlstm-1.3b", "1x1024"))
SWARM_COMPUTE_SCALES = "1,1.5,2"
SWARM_Q_SCALES = "0.8,1,1.25"
SWARM_MEMORY_SCALES = "1,0.5,2"
SWARM_MEMORY_SHARE = 1.0
SWARM_CHAIN = (512, 4, "1,1.5,2,1")   # tasks, nodes, compute scales
SWARM_ARRAYS = ("inner_S", "inner_A", "outer_dp", "outer_parent", "e_total", "k_used")


def random_ns_profile(directory: Path, n: int, seed: int):
    """A seeded random NS Optimizer profile (``prof.csv``, ``dep.csv``): a
    chain of ``n`` layers, each reading its predecessor and, one in four,
    a layer up to 8 back; layer times 0.1-1 ms, outputs 0.01-2 mb."""
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    prof = ["Layer name,time,output mb,memory mb,MACs"]
    dep = ["Source,Destination"]
    for i in range(n):
        prof.append(f"L{i},{rng.uniform(1e-4, 1e-3)!r},{rng.uniform(0.01, 2.0)!r},"
                    f"{rng.uniform(0.1, 4.0)!r},0")
        if i >= 1:
            dep.append(f"L{i - 1},L{i}")
        if i >= 2 and rng.random() < 0.25:
            dep.append(f"L{int(rng.integers(max(0, i - 8), i - 1))},L{i}")
    (directory / "prof.csv").write_text("\n".join(prof) + "\n")
    (directory / "dep.csv").write_text("\n".join(dep) + "\n")
    return str(directory / "prof.csv"), str(directory / "dep.csv")


def swarm_case(name, mode, nodes, scales, workdir: Path, dev) -> dict:
    """One run of the swarm CLI (``repro_torch.launch.swarm.main``) on the
    card, then the same spec solved again by ``solve_placement_torch`` on
    the card and by the numpy oracle: all six DP arrays bitwise equal, and
    the CLI's ``--table-out`` byte-equal to the table built from the numpy
    sweep with the same meta."""
    import argparse
    import contextlib
    import io

    from repro_torch.core.placement import (PLACEMENT_COUNT, LinkModel, PlacementSpec,
                                            PlacementTable, placement_inputs,
                                            solve_placement_numpy)
    from repro_torch.core.placement_torch import solve_placement_torch
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import swarm

    loaded = argparse.Namespace(**{"prof": None, "dep": None, "arch": None,
                                   "buckets": "2x16", "full": True, "kind": None, **mode})
    graph, cm, _ = swarm.load_graph(loaded)
    n = graph.n_tasks
    one = placement_inputs(graph, cm, PlacementSpec(nodes=1, link=LinkModel(900.0)))
    memory = SWARM_MEMORY_SHARE * float(one.mem[1, n])
    table_path = workdir / f"{name}.json"
    argv = (["--prof", mode["prof"], "--dep", mode["dep"]] if "prof" in mode
            else ["--arch", mode["arch"], "--full", "--buckets", mode["buckets"]])
    argv += ["--nodes", str(nodes), "--node-memory", repr(memory), "--q-scales",
             SWARM_Q_SCALES, "--memory-scales", SWARM_MEMORY_SCALES,
             "--device", dev.type, "--table-out", str(table_path)]
    if scales:
        argv += ["--compute-scales", scales]
    backend = "scan" if dev.type == "cuda" else "scan-cpu"
    l0, c0 = sweep_columns_cuda.launches, PLACEMENT_COUNT[backend]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = swarm.main(argv)
    cli_s = time.perf_counter() - t0
    cli_launches = sweep_columns_cuda.launches - l0
    cli_scan_solves = PLACEMENT_COUNT[backend] - c0
    meta = json.loads(table_path.read_text())["meta"]

    spec, _ = swarm.build_swarm_spec(graph, cm, argparse.Namespace(
        node_q=meta["node_q"], compute_scales=scales, nodes=nodes, node_memory=memory,
        bandwidths="900:3400:100", q_scales=SWARM_Q_SCALES,
        memory_scales=SWARM_MEMORY_SCALES, backend="auto", device=dev.type))
    inputs = placement_inputs(graph, cm, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = solve_placement_torch(graph, cm, spec, inputs=inputs, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    t0 = time.perf_counter()
    want = solve_placement_numpy(graph, cm, spec, inputs=inputs)
    numpy_s = time.perf_counter() - t0
    differ = [f for f in SWARM_ARRAYS
              if not (getattr(got, f).dtype == getattr(want, f).dtype
                      and getattr(got, f).shape == getattr(want, f).shape
                      and getattr(got, f).tobytes() == getattr(want, f).tobytes())]
    oracle_path = workdir / f"{name}.numpy.json"
    PlacementTable(dataclasses.replace(want, backend=got.backend), meta=meta).to_json(
        str(oracle_path))
    table_equal = table_path.read_bytes() == oracle_path.read_bytes()
    L, M, Z = spec.grid_shape
    row = {"case": name, "tasks": n, "nodes": nodes, "compute_scales": scales or None,
           "grid": [L, M, Z], "node_q": meta["node_q"], "node_memory": memory,
           "cli_rc": rc, "cli_s": cli_s, "cli_sweep_launches": cli_launches,
           "cli_scan_solves": cli_scan_solves,
           "cli_ledger_line": next((ln for ln in out.getvalue().splitlines()
                                    if ln.startswith("[swarm] ledger")), None),
           "card_solve_s": card_s, "numpy_solve_s": numpy_s, "card_peak_bytes": peak,
           "feasible_cells": int(np.isfinite(got.e_total).sum()),
           "nodes_used": np.bincount(got.k_used.ravel(), minlength=nodes + 1).tolist(),
           "arrays_differ": differ, "table_byte_equal_numpy": table_equal}
    ok = (rc == 0 and not differ and table_equal and cli_scan_solves == 1
          and cli_launches == 1 and 0 < row["feasible_cells"]
          and (row["feasible_cells"] < L * M * Z or not scales))
    if not ok:
        raise AssertionError(f"swarm case failed: {row}\n{out.getvalue()[-2000:]}")
    row["_table"], row["_memory"], row["_inputs"] = table_path, memory, inputs
    return row


def placement_path(workdir: Path, dev) -> dict:
    """The swarm path on the card: each case of SWARM_ARCHS at full width,
    qwen3-4b's bucket also homogeneous (the ``dse --placement`` phase's
    spec), the ns_mini fixture and a seeded random 512-task chain over 4
    nodes (see :func:`swarm_case`); the sweep kernel's launches are the
    per-node budgets' Q_min solves, and the device ops of one inner
    column of the chain's solve."""
    from repro_torch.core.placement_torch import _inner_dp, _lane_energies
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda

    workdir.mkdir(parents=True, exist_ok=True)
    fixture = ROOT / "tests" / "fixtures" / "ns_mini"
    prof, dep = random_ns_profile(workdir / "chain", SWARM_CHAIN[0], seed=0)
    cases = [(arch, {"arch": arch, "buckets": b}, 3, SWARM_COMPUTE_SCALES)
             for arch, b in SWARM_ARCHS]
    cases += [("qwen3-4b-homogeneous", {"arch": "qwen3-4b", "buckets": SWARM_ARCHS[0][1]},
               3, ""),
              ("ns_mini", {"prof": str(fixture / "prof.csv"), "dep": str(fixture / "dep.csv")},
               3, SWARM_COMPUTE_SCALES),
              ("chain512", {"prof": prof, "dep": dep}, SWARM_CHAIN[1], SWARM_CHAIN[2])]
    sweep_columns_cuda.launches = 0
    t0 = time.perf_counter()
    rows = [swarm_case(name, mode, nodes, scales, workdir, dev)
            for name, mode, nodes, scales in cases]
    seconds = time.perf_counter() - t0
    launches = sweep_columns_cuda.launches

    # device ops of the chain's inner DP (every (node, q_scale) lane at once)
    inp = rows[-1]["_inputs"]
    n, lanes = inp.n_tasks, inp.n_nodes * inp.q_thresh.shape[1]
    ec = _lane_energies(inp, dev)
    _inner_dp(ec, n)
    kernels = profile_device(lambda: _inner_dp(ec, n))
    inner_launches = sum(c for us, c in kernels.values() if us > 0)
    row = {"phase": "placement", "seconds": seconds, "sweep_launches": launches,
           "cases": [{k: v for k, v in r.items() if not k.startswith("_")} for r in rows],
           "chain_inner_device_launches": inner_launches,
           "chain_inner_ops_per_column": inner_launches / n,
           "chain_inner_lanes": lanes}
    emit(row)
    if launches != len(rows):
        raise AssertionError(f"placement: {launches} sweep launches for {len(rows)} "
                             "Q_min solves")
    return {"launches": launches, "tables": {r["case"]: r["_table"] for r in rows},
            "memory": {r["case"]: r["_memory"] for r in rows}}


def sharded_sweeps(cases, dev) -> list:
    """Q shards on the sweep kernel through the façade: each (graphs, grid,
    shard count) solved whole and in chunks, every sweep table bitwise
    equal. The chunks' lane counts set other cluster layouts than the whole
    grid's (warps a lane, CTAs, dp in shared or device memory)."""
    from repro_torch.api import PartitionSpec, QGridSharding, solve
    from repro_torch.core.partition_torch import shard_q_grid
    from repro_torch.kernels._build import smem_optin
    from repro_torch.kernels.partition_sweep.kernel import (lane_warps, sweep_columns_cuda,
                                                            sweep_layout)

    def layout(n, nq):
        lay = sweep_layout(n, nq, smem_optin(dev.index or 0))
        return [nq, lane_warps(nq), lay.cluster, lay.dp_in_smem]

    rows = []
    for name, graphs, cm, qs, k in cases:
        spec = dict(graphs=tuple(graphs), cost=cm, q_grid=tuple(qs),
                    backend="cuda" if dev.type == "cuda" else "torch")
        whole = solve(PartitionSpec(**spec)).sweeps
        l0 = sweep_columns_cuda.launches
        got = solve(PartitionSpec(sharding=QGridSharding(k), **spec)).sweeps
        differ = [f for a, b in zip(got, whole)
                  for f in ("dp", "parent", "e_total", "feasible", "starts")
                  if getattr(a, f).tobytes() != getattr(b, f).tobytes()]
        n = max(g.n_tasks for g in graphs)
        chunks = shard_q_grid(len(qs), k)
        rows.append({"case": name, "graphs": len(graphs), "q_points": len(qs),
                     "shards": len(chunks), "launches": sweep_columns_cuda.launches - l0,
                     "whole_layout": layout(n, len(qs)),
                     "chunk_layouts": sorted({tuple(layout(n, hi - lo)) for lo, hi in chunks}),
                     "differ": differ})
    return rows


def dse_path(built, ledger, swarm, thermal, workdir: Path, dev) -> int:
    """The ``dse`` CLI on the card: qwen3-4b's full-width time table built
    with 1, 2 and 3 Q shards (content digests equal to each other and to
    the plan_table phase's table); a 4-bucket × 9-Q base extended by 4
    buckets and 8 Q points (equal to a fresh build of the union grid, with
    only the new cells solved, read from the extension's trace); the probe
    at k=8; ``--calibrate`` on the traffic run's ledger (passes) and on the
    same ledger drifted ×1.8 (refused); ``--placement`` whose payload equals
    the swarm phase's homogeneous qwen3-4b table. Then :func:`sharded_sweeps`
    on one-point chunks of qwen3-4b's grid and on THERMAL's 96-lane grid
    (``thermal``: graph, cost, grid) in 5 and in 96 chunks. Returns the
    sweep launches of the phase."""
    from repro_torch.configs import get_config
    from repro_torch.core.layer_profile import default_cost_model
    from repro_torch.core.plan_table import PlanTable, build_plan_table
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import dse
    from repro_torch.launch.planner import lower_buckets
    from repro_torch.obs.trace import TRACER

    workdir.mkdir(parents=True, exist_ok=True)
    ref = next(t["table"] for t in built if t["arch"] == "qwen3-4b" and t["kind"] == "time")
    arch = ["--arch", "qwen3-4b", "--full", "--device", dev.type]
    every = ",".join(f"{b}x{s}" for b, s in QWEN_TABLE_BUCKETS)
    sweep_columns_cuda.launches = 0

    def run(argv):
        l0, t0 = sweep_columns_cuda.launches, time.perf_counter()
        rc = dse.main(arch + argv)
        return rc, sweep_columns_cuda.launches - l0, time.perf_counter() - t0

    shards = []
    for k in (1, 2, 3):
        path = workdir / f"qwen_time_shards{k}.npz"
        rc, launches, secs = run(["--buckets", every, "--shards", str(k), "--out", str(path)])
        t = PlanTable.load(str(path))
        shards.append({"shards": k, "rc": rc, "sweep_launches": launches, "seconds": secs,
                       "digest": t.content_digest()[:16],
                       "equal_plan_table_phase": t.content_digest() == ref.content_digest()})
    nb = len(QWEN_TABLE_BUCKETS)
    shards_ok = all(r["rc"] == 0 and r["equal_plan_table_phase"]
                    and r["sweep_launches"] == nb * (1 + r["shards"]) for r in shards)

    base_path = workdir / "qwen_time_extend.npz"
    first = ",".join(f"{b}x{s}" for b, s in QWEN_TABLE_BUCKETS[:4])
    rc_base, base_launches, _ = run(["--buckets", first, "--q-points", "8",
                                     "--out", str(base_path)])
    base = PlanTable.load(str(base_path))
    finite = [q for q in base.q_values() if q is not None]
    add = [float(q) for q in np.geomspace(min(finite) * 1.03, max(finite) * 0.97, 8)]
    trace_path = workdir / "extend_trace.json"
    rc_ext, ext_launches, ext_s = run(["--buckets", every, "--extend", "--add-q",
                                       ",".join(repr(q) for q in add), "--out", str(base_path),
                                       "--trace-out", str(trace_path)])
    TRACER.disable()
    TRACER.reset()
    ext = PlanTable.load(str(base_path))
    solved = [[ev["args"]["graphs"], ev["args"]["q_points"]]
              for ev in json.loads(trace_path.read_text())["traceEvents"]
              if ev.get("name") == "plan_table.extend"]
    fresh = build_plan_table(get_config("qwen3-4b"), QWEN_TABLE_BUCKETS,
                             base.q_values() + add, kind="time",
                             backend="cuda" if dev.type == "cuda" else "torch")
    extend = {"base": [base.n_buckets, base.n_q], "base_rc": rc_base,
              "base_sweep_launches": base_launches, "rc": rc_ext,
              "final": [ext.n_buckets, ext.n_q], "sweep_launches": ext_launches,
              "seconds": ext_s, "solved_blocks": solved,
              "cells_solved": sum(g * q for g, q in solved),
              "cells_moved": base.n_buckets * base.n_q,
              "equal_fresh_build": ext.content_digest() == fresh.content_digest(),
              "lineage": len(ext.lineage)}
    extend_ok = (rc_base == rc_ext == 0 and extend["equal_fresh_build"]
                 and extend["final"] == [nb, base.n_q + 8]
                 and solved == [[nb - 4, base.n_q + 8], [4, 8]]
                 and ext_launches == nb and extend["lineage"] == 2)

    shard1 = str(workdir / "qwen_time_shards1.npz")
    rc_probe, probe_launches, probe_s = run(["--probe-only", "--probe", "8", "--out", shard1])
    clean_path, drift_path = workdir / "traffic_ledger.json", workdir / "drifted_ledger.json"
    ledger.dump_json(str(clean_path), kind="time")
    payload = json.loads(clean_path.read_text())
    for e in payload["entries"]:
        e["energy"] *= 1.8
    drift_path.write_text(json.dumps(payload, indent=2) + "\n")
    rc_cal, cal_launches, cal_s = run(["--calibrate", str(clean_path), "--out", shard1])
    rc_drift, _, _ = run(["--calibrate", str(drift_path), "--out", shard1,
                          "--calibration-out", str(workdir / "drifted.calib.json")])

    place_path = workdir / "qwen_placement.json"
    rc_place, place_launches, place_s = run([
        "--placement", "--buckets", SWARM_ARCHS[0][1], "--nodes", "3",
        "--node-memory", repr(swarm["memory"]["qwen3-4b-homogeneous"]),
        "--q-scales", SWARM_Q_SCALES, "--memory-scales", SWARM_MEMORY_SCALES,
        "--out", str(place_path)])
    got = json.loads(place_path.read_text())
    want = json.loads(swarm["tables"]["qwen3-4b-homogeneous"].read_text())

    def solved_content(p):
        # the swarm CLI names its nodes and writes its own meta; dse does neither
        return {**{k: v for k, v in p.items() if k not in ("meta", "fingerprint")},
                "nodes": [{k: v for k, v in nd.items() if k != "name"} for nd in p["nodes"]]}

    place_equal = solved_content(got) == solved_content(want)
    g_th, cm_th, grid_th = thermal
    qwen = lower_buckets(get_config("qwen3-4b"), QWEN_TABLE_BUCKETS, "time")
    qs = ref.q_values()
    sharded = sharded_sweeps([("qwen3-4b one-point chunks", qwen, default_cost_model("time"),
                               qs, len(qs)),
                              ("thermal 96 lanes in 5", [g_th], cm_th, grid_th, 5),
                              ("thermal 96 lanes in 96", [g_th], cm_th, grid_th, 96)], dev)
    launches = sweep_columns_cuda.launches
    row = {"phase": "dse", "shards": shards, "extend": extend,
           "probe_only": {"rc": rc_probe, "cells": 8, "sweep_launches": probe_launches,
                          "seconds": probe_s},
           "calibrate": {"rc": rc_cal, "sweep_launches": cal_launches, "seconds": cal_s,
                         "drifted_x1.8_rc": rc_drift},
           "placement": {"rc": rc_place, "sweep_launches": place_launches,
                         "seconds": place_s, "payload_equal_swarm": place_equal},
           "sharded_sweeps": sharded, "sweep_launches": launches}
    emit(row)
    if not (shards_ok and extend_ok and rc_probe == 0 and rc_cal == 0 and rc_drift != 0
            and rc_place == 0 and place_equal
            and all(not r["differ"] and r["launches"] == r["graphs"] * r["shards"]
                    for r in sharded)):
        raise AssertionError(f"dse check failed: {row}")
    return launches


# -- the model zoo ----------------------------------------------------------------

# (arch, layers served (None: all), requests (batch, prompt, generated
# tokens)), in the order served, each at its full width with random weights
# from seed 0. deepseek-coder-33b (about 62 GiB of bf16 weights) runs last;
# phi3.5-moe runs 16 of its 32 layers: its 78 GiB of bf16 weights do not fit
# in 80 GB beside a cache.
ZOO = (
    ("tinyllama-1.1b", None, ((4, 512, 16),)),
    ("qwen1.5-0.5b", None, ((4, 512, 16),)),
    ("granite-moe-1b-a400m", None, ((4, 512, 16),)),
    ("llama-3.2-vision-11b", None, ((4, 512, 16),)),
    ("whisper-large-v3", None, ((4, 128, 16),)),
    ("phi3.5-moe-42b-a6.6b", 16, ((4, 512, 16),)),
    ("deepseek-coder-33b", None, ((1, 512, 8),)),
    ("zamba2-7b", None, ((4, 512, 16), (1, 2048, 8))),
)
# The zoo's parity control: the plain path with its RMSNorm and attention
# outputs × (1 + 2^-3) past position 64 (a fault of both kernels). qwen3-4b's
# control is attention × (1 + 2^-4); the zoo's is larger and reaches the
# RMSNorms too, since in the MoE models the experts, not attention, carry
# most of the residual stream.
ZOO_CONTROL = 2.0 ** -3
ZOO_GATE = 0.5          # the vlm cross gates of the second prefill (repro's are 0)
# The zoo's planned requests, each on a time table the planner CLI builds
# for its bucket: (batch, prompt, generated), decode steps per energy cycle,
# the cycle after which a power failure is injected.
ZOO_PLANNED = {"whisper-large-v3": ((1, 128, 8), 3, 1), "zamba2-7b": ((1, 512, 8), 3, 1)}


def held_params(cfg, max_seq: int) -> int:
    """The numbers ``cfg``'s model holds, counted from its layout (the
    reference's parameter tree): q/k-norm weights, QKV biases, a tied head
    (none of its own), the vlm's self and cross layers (a cross layer: its
    attention, one norm and a gate), whisper's LayerNorm biases, GELU-MLP
    biases and learned positions (``max_seq`` decoder rows), zamba2's Mamba2
    blocks (in_proj with its B, C and dt columns, the conv, A_log, dt_bias,
    D, out_proj, a norm) and its one shared block (q/k/v from 2d, a 2d norm,
    an MLP norm, SwiGLU)."""
    d, hd, ff = cfg.d_model, cfg.hd, cfg.d_ff
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    proj = 2 * d * nq + 2 * d * nkv
    attn = proj + ((nq + 2 * nkv) if cfg.qkv_bias else 0) + (2 * hd if cfg.qk_norm else 0)
    if cfg.family == "hybrid":
        d_in, n = cfg.ssm_expand * d, cfg.ssm_state
        h = d_in // cfg.ssm_headdim
        mamba = d * (2 * d_in + 2 * n + h) + 4 * (d_in + 2 * n) + 3 * h + d_in * d + d
        shared = 2 * d * (nq + 2 * nkv) + nq * d + 3 * d + 3 * d * ff
        return 2 * cfg.vocab * d + d + cfg.n_layers * mamba + shared
    if cfg.family == "encdec":
        mlp = 2 * d * ff + ff + d
        return (2 * cfg.vocab * d + (cfg.n_audio_frames + max_seq) * d + 4 * d
                + cfg.n_encoder_layers * (attn + mlp + 4 * d)
                + cfg.n_layers * (attn + proj + mlp + 6 * d))
    n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" else 0
    if cfg.family == "moe":
        m = cfg.moe
        ffn = d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
    else:
        ffn = 3 * d * ff
    head = 0 if cfg.tie_embeddings else cfg.vocab * d
    return (cfg.vocab * d + head + d + (cfg.n_layers - n_cross) * (attn + ffn + 2 * d)
            + n_cross * (proj + d + 1))


def stand_in(cfg, dev, seed: int = 5):
    """b → the vlm's or whisper's stand-ins (``api.extra_inputs``), seeded
    random normal bf16 instead of the zeros serving feeds."""
    from repro_torch.models import api

    def make(b):
        gen = torch.Generator(device=dev).manual_seed(seed + b)
        return {name: _randn(gen, shape, dtype, dev)
                for name, (shape, dtype) in api.extra_inputs(cfg, b).items()}
    return make


@contextlib.contextmanager
def cross_gates(params, value):
    """Sets every vlm cross gate of ``params`` to ``value`` inside the block
    and restores them after; ``value`` None (or a model without cross
    gates) changes nothing."""
    gates = [] if value is None else [layer.gate for layer in getattr(params, "cross", ())]
    saved = [g.clone() for g in gates]
    for g in gates:
        g.fill_(value)
    try:
        yield
    finally:
        for g, kept in zip(gates, saved):
            g.copy_(kept)


def _one_step(y, share: float, gen):
    """``y`` (bf16) with a random ``share`` of its elements moved one bf16
    step up or down, the direction at random: the difference between two
    correct roundings of the same value."""
    f = y.to(torch.float32)
    step = torch.exp2(torch.floor(torch.log2(f.abs().clamp_min(1e-30))) - 7)
    pick = torch.rand(f.shape, generator=gen, device=f.device) < share
    sign = torch.where(torch.rand(f.shape, generator=gen, device=f.device) < 0.5, -1.0, 1.0)
    return torch.where(pick & (f != 0), f + sign * step, f).to(y.dtype)


def rounding_reference(dev, seed: int = 7):
    """The plain path made to differ from itself as the kernel path does:
    at every kernel site the kernel and its plain version run on the same
    input, and the plain output leaves with as many elements one bf16 step
    off as the kernel's output differs from it, at random places and in
    random directions. Its logits' distance from the plain path is the
    model's response to the kernels' rounding at their own sites."""
    from repro_torch.models.common import KERNELS, PLAIN

    gen = torch.Generator(device=dev).manual_seed(seed)

    def shadow(kernel_fn, plain_fn):
        def fn(*args, **kw):
            got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            share = float((got != want).to(torch.float32).mean())
            return _one_step(want, share, gen)
        return fn

    return dataclasses.replace(PLAIN, rmsnorm=shadow(KERNELS.rmsnorm, PLAIN.rmsnorm),
                               attention=shadow(KERNELS.attention, PLAIN.attention))


def _scaled_rmsnorm(excess: float, first: int):
    """The plain RMSNorm with its output scaled by 1 + ``excess`` at
    positions (axis 1) from ``first`` on."""
    def rmsnorm(x, w, eps):
        from repro_torch.models.common import PLAIN

        y = PLAIN.rmsnorm(x, w, eps)
        scale = torch.ones(y.shape[1], device=y.device, dtype=torch.float32)
        scale[first:] += excess
        return (y.to(torch.float32) * scale.view(1, -1, *([1] * (y.dim() - 2)))).to(y.dtype)
    return rmsnorm


class RoutePin:
    """Records the routing of every MoE layer of ``params`` on one run and
    replays it on the next ones, so that a path compared with the plain
    path takes the plain path's experts: a near-tie route that flips
    between two bf16 paths is a discontinuity, not rounding. No-op for a
    model without MoE layers."""

    def __init__(self, params):
        from repro_torch.models.moe import MoE

        self.mods = [layer.mlp for layer in getattr(params, "layers", ())
                     if isinstance(layer.mlp, MoE)]
        self.log = {id(m): [] for m in self.mods}

    @contextlib.contextmanager
    def record(self):
        for m in self.mods:
            self.log[id(m)] = []

            def route_probs(probs, m=m, fn=type(m).route_probs):
                r = fn(m, probs)
                self.log[id(m)].append(r)
                return r
            m.route_probs = route_probs
        try:
            yield
        finally:
            for m in self.mods:
                del m.route_probs

    @contextlib.contextmanager
    def replay(self):
        for m in self.mods:
            m.route_probs = lambda probs, it=iter(self.log[id(m)]): next(it)
        try:
            yield
        finally:
            for m in self.mods:
                del m.route_probs


def zoo_parity(cfg, params, dev, requests, extra=None) -> dict:
    """The kernel path against the plain path on the same weights, per
    logits row (‖Δ‖₂/‖plain‖₂): the last prefill position with serving's
    inputs (zero stand-ins) and the decode steps under teacher forcing (the
    plain path fed the kernel path's tokens); with ``extra``, a second
    prefill on seeded random stand-ins with the vlm cross gates at
    ZOO_GATE. The limit is twice the largest reading of
    :func:`rounding_reference` on the same rows: every kernel row within
    it; the control (both kernels' outputs × (1 + ZOO_CONTROL) past
    position 64) above it in every prefill row. MoE paths take the plain
    path's routes (:class:`RoutePin`); the kernel path's reading with its
    own routes is kept beside them."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS, PLAIN

    rounding = rounding_reference(dev)
    control = dataclasses.replace(PLAIN, attention=_scaled_attention(ZOO_CONTROL, 64),
                                  rmsnorm=_scaled_rmsnorm(ZOO_CONTROL, 64))
    paths = {"kernel": KERNELS, "rounding": rounding, "control": control}
    pin = RoutePin(params)
    out = []
    for b, p, g in requests:
        tokens = _tokens(cfg, b, p, dev, b * 7919 + p)
        cases = [("zero_stand_in", S._pre_batch(cfg, tokens))]
        if extra is not None:
            cases.append(("random_stand_in_gates", {"tokens": tokens, **extra(b)}))
        row = {"batch": b, "prompt": p, "gen": g}
        for name, inputs in cases:
            with cross_gates(params, None if name == "zero_stand_in" else ZOO_GATE):
                with pin.record():
                    pl, pc = api.prefill(cfg, params, inputs, p + g, PLAIN)
                logits, caches, reading = {}, {}, {}
                for path, ks in paths.items():
                    with pin.replay():
                        logits[path], caches[path] = api.prefill(cfg, params, inputs, p + g, ks)
                    reading[f"{path}_prefill"] = _row_rel(logits[path], pl)
                if pin.mods:
                    free, _ = api.prefill(cfg, params, inputs, p + g)
                    reading["kernel_own_routes_prefill"] = _row_rel(free, pl)
                    del free
            if name == "zero_stand_in":
                tok = logits["kernel"][:, -1].argmax(dim=-1, keepdim=True)
                dec = {"kernel": [], "rounding": []}
                for i in range(g - 1):
                    with pin.record():
                        step, pc = api.decode_step(cfg, params, pc, tok, p + i, PLAIN)
                    for path in dec:
                        with pin.replay():
                            got, caches[path] = api.decode_step(cfg, params, caches[path], tok,
                                                                p + i, paths[path])
                        if not bool(torch.isfinite(got).all()):
                            raise AssertionError(f"{cfg.name}: {path} path logits not finite")
                        dec[path].append(_row_rel(got, step))
                        if path == "kernel":
                            next_tok = got[:, -1].argmax(dim=-1, keepdim=True)
                    tok = next_tok
                for path, rows in dec.items():
                    if rows:
                        reading[f"{path}_decode"] = torch.cat(rows)
            row[name] = {k: [float(v.min()), float(v.max())] for k, v in reading.items()}
            del pc, caches, logits
        out.append(row)
    limit = 2 * max(v[1] for r in out for c in r.values() if isinstance(c, dict)
                    for k, v in c.items() if k.startswith("rounding"))
    reading = {"phase": "zoo_kernel_vs_plain_path", "arch": cfg.name, "requests": out,
               "limit": limit,
               "limit_rule": "2 x the largest row of the rounding reference (the plain path "
                             "with as many one-step bf16 differences at each kernel site as "
                             "the kernel makes there)",
               "reading": "per logits row ‖Δ‖₂/‖plain‖₂, [min, max] over rows",
               "control": f"plain path, RMSNorm and attention x (1 + {ZOO_CONTROL}) past "
                          "position 64",
               "routes": "MoE paths replay the plain path's routes" if pin.mods else None}
    emit(reading)
    for r in out:
        for name, c in r.items():
            if not isinstance(c, dict):
                continue
            worst = max(v[1] for k, v in c.items() if k in ("kernel_prefill", "kernel_decode"))
            if worst > limit:
                raise AssertionError(f"{cfg.name} kernel path off the plain path ({name}): "
                                     f"{worst} > {limit}")
            if c["control_prefill"][0] <= limit:
                raise AssertionError(f"{cfg.name}: the control passed the parity check "
                                     f"({name}): the check does not discriminate")
    return reading


def moe_routing(cfg, params, dev, request) -> dict:
    """The routing of ``cfg``'s MoE layers at full width on one prefill of
    ``request``: the share of (token, choice) pairs dropped at capacity in
    each layer of the kernel path; the first layer's routing on the card
    against the CPU's on the same float32 probabilities, and on the same
    probabilities rounded to sixteenths (ties everywhere): experts, queue
    positions and drops equal, gates within 2^-20 relative (their sum of k
    terms may add in another order); and, for the record, the first
    layer's routes on the kernel path against the plain path, each on its
    own MoE input (ln1 RMSNorm, flash attention, residual, ln2 RMSNorm):
    near-tie bf16 logits may route apart."""
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS, PLAIN, rmsnorm
    from repro_torch.models.moe import moe_capacity, route

    b, p, g = request
    m = cfg.moe
    capacity = moe_capacity(m, min(1024, p))
    tokens = _tokens(cfg, b, p, dev, 31 + b)
    counts = []

    def hook(mod, args):
        kept = mod.routing(args[0]).kept
        counts.append((int((~kept).sum()), kept.numel()))

    hooks = [layer.mlp.register_forward_pre_hook(hook) for layer in params.layers]
    try:
        api.prefill(cfg, params, {"tokens": tokens}, p + g)
    finally:
        for h in hooks:
            h.remove()
    layer, eps = params.layers[0], cfg.norm_eps
    x = params.embed[tokens]
    positions = torch.arange(p, device=dev)[None]
    inputs = {}
    with torch.no_grad():
        for name, ks in (("kernel", KERNELS), ("plain", PLAIN)):
            a, _ = layer.attn(rmsnorm(x, layer.ln1, eps, ks), positions, ks)
            inputs[name] = rmsnorm(x + a, layer.ln2, eps, ks)
        routes = {name: layer.mlp.routing(h) for name, h in inputs.items()}
        probs = layer.mlp.router_probs(inputs["plain"])
    card_cpu = {}
    for name, pr in (("probabilities", probs), ("ties", torch.round(probs * 16) / 16)):
        on_card, on_cpu = route(pr, m.top_k, capacity), route(pr.cpu(), m.top_k, capacity)
        gate_rel = float(((on_card.gate.cpu() - on_cpu.gate).abs()
                          / on_cpu.gate.clamp_min(1e-30)).max())
        card_cpu[name] = {"sel": torch.equal(on_card.sel.cpu(), on_cpu.sel),
                          "pos": torch.equal(on_card.pos.cpu(), on_cpu.pos),
                          "kept": torch.equal(on_card.kept.cpu(), on_cpu.kept),
                          "gate_max_rel_diff": gate_rel}
    equal = (routes["kernel"].sel == routes["plain"].sel).float().mean().item()
    dropped = sum(n for n, _ in counts)
    pairs = sum(t for _, t in counts)
    row = {"phase": "zoo_moe_routing", "arch": cfg.name,
           "request": {"batch": b, "prompt": p}, "experts": m.n_experts, "top_k": m.top_k,
           "capacity": capacity, "layers": len(counts), "dropped_share": dropped / pairs,
           "dropped_share_by_layer": [n / t for n, t in counts],
           "card_routing_against_cpu": card_cpu,
           "first_layer_own_input_equal_route_share": equal,
           "first_layer_own_input_routes_differing": int(
               (routes["kernel"].sel != routes["plain"].sel).sum())}
    emit(row)
    exact = all(c["sel"] and c["pos"] and c["kept"] and c["gate_max_rel_diff"] <= 2.0 ** -20
                for c in card_cpu.values())
    if len(counts) != cfg.n_layers or not exact:
        raise AssertionError(f"{cfg.name}: MoE routing check failed")
    return row


# zamba2's chunked prefill against its recurrence: the last RECURRENCE_TOKENS
# prompt positions fed one at a time after a prefill of the rest, against
# one prefill of the whole prompt. The layer check's control is that one
# prefill with the last chunk's log-decays × (1 + RECURRENCE_CONTROL): a
# decay rate doubled in one chunk.
RECURRENCE_TOKENS = 128
RECURRENCE_CONTROL = 1.0


def _mamba_cells(params) -> list:
    return [blk.cell for grp in params.groups for blk in grp] + [blk.cell for blk in params.tail]


@contextlib.contextmanager
def mamba2_decays(params, seed: int = 13):
    """Every Mamba2 block's A_log and dt_bias set to Mamba2's published
    initialisation inside the block (A uniform in [1, 16], dt log-uniform
    in [1e-3, 1e-1] through the inverse softplus; seeded), restored after.
    With ``repro``'s zeros a head keeps exp(-softplus(dt)) of its state a
    step, a few tokens' memory, and nothing crosses a 128-token chunk."""
    cells = _mamba_cells(params)
    saved = [(c.A_log.clone(), c.dt_bias.clone()) for c in cells]
    dev = cells[0].A_log.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = math.log(1e-3), math.log(1e-1)
    for c in cells:
        h = c.A_log.shape[0]
        c.A_log.copy_(torch.log(1 + 15 * torch.rand(h, generator=gen, device=dev)))
        dt = torch.exp(lo + (hi - lo) * torch.rand(h, generator=gen, device=dev))
        c.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    try:
        yield
    finally:
        for c, (a, b) in zip(cells, saved):
            c.A_log.copy_(a)
            c.dt_bias.copy_(b)


@contextlib.contextmanager
def mamba2_decay_fault(params, last: int, excess: float):
    """Inside the block, every Mamba2 prefill's log-decays at the last
    ``last`` positions × (1 + ``excess``): one chunk's decay wrong."""
    cells = _mamba_cells(params)
    for c in cells:
        def discretize(dt, c=c, fn=type(c)._discretize):
            logdec, dt_eff = fn(c, dt)
            if logdec.dim() == 3:  # [B, S, H]: a prefill, not a decode step
                logdec = logdec.clone()
                logdec[:, -last:] *= 1.0 + excess
            return logdec, dt_eff
        c._discretize = discretize
    try:
        yield
    finally:
        for c in cells:
            del c._discretize


def _last_one_step(t, last: int, gen):
    """``t`` with every element at its last ``last`` positions (axis 1) one
    bf16 step off, in a random direction."""
    t = t.clone()
    t[:, -last:] = _one_step(t[:, -last:], 1.0, gen)
    return t


@contextlib.contextmanager
def mamba2_one_step(params, last: int, gen):
    """Inside the block, every Mamba2 block's input and output at the last
    ``last`` positions one bf16 step off at every element."""
    cells = _mamba_cells(params)
    for c in cells:
        def forward(x, state=None, c=c, fn=type(c).forward):
            y, st = fn(c, _last_one_step(x, last, gen), state)
            return _last_one_step(y, last, gen), st
        c.forward = forward
    try:
        yield
    finally:
        for c in cells:
            del c.forward


def _state_rel(got, want):
    """max|got − want| / max|want| of each layer's state (axis 0), on the host."""
    got, want = got.flatten(1), want.flatten(1)
    return ((got - want).abs().amax(dim=1) / want.abs().amax(dim=1)).cpu()


def mamba2_layer_checks(cfg, params, dev, request, gen) -> dict:
    """Each Mamba2 block alone on the input it has in one prefill of
    ``request``: its chunked pass over all p positions against a chunked
    pass over p − 128 then 128 single steps, on the same bf16 input, read as
    :func:`_state_rel` of the float32 states. The limit of each layer is
    twice the reading of its chunked pass on that input with every element
    of the last 128 positions one bf16 step off; the control, the last
    chunk's log-decays × (1 + RECURRENCE_CONTROL), must exceed it in every
    layer."""
    from repro_torch.models import api

    b, p, g = request
    head = p - RECURRENCE_TOKENS
    cells, inputs = _mamba_cells(params), []
    for c in cells:
        def forward(x, state=None, c=c, fn=type(c).forward):
            inputs.append(x)
            return fn(c, x, state)
        c.forward = forward
    try:
        api.prefill(cfg, params, {"tokens": _tokens(cfg, b, p, dev, 43 + b)}, p + g)
    finally:
        for c in cells:
            del c.forward
    rec, ref, ctl = [], [], []
    for c, u in zip(cells, inputs):
        whole = c(u)[1]["ssm"]
        ref.append(c(_last_one_step(u, RECURRENCE_TOKENS, gen))[1]["ssm"])
        with mamba2_decay_fault(params, RECURRENCE_TOKENS, RECURRENCE_CONTROL):
            ctl.append(c(u)[1]["ssm"])
        _, st = c(u[:, :head])
        for t in range(head, p):
            _, st = c.decode(u[:, t:t + 1], st)
        rec.append(st["ssm"])
        rec[-1], ref[-1], ctl[-1] = (_state_rel(x[None], whole[None]) for x in
                                     (rec[-1], ref[-1], ctl[-1]))
    del inputs
    rec, ref, ctl = (torch.cat(x) for x in (rec, ref, ctl))
    limit = 2 * ref
    return {"batch": b, "prompt": p, "layers": len(cells),
            "state_largest_share_of_limit": float((rec / limit).max()),
            "control_smallest_share_of_limit": float((ctl / limit).min()),
            "state_rel_max": float(rec.max()),
            "state_limit_min_max": [float(limit.min()), float(limit.max())],
            "state_rel_by_layer": rec.tolist(), "state_limit_by_layer": limit.tolist(),
            "control_rel_by_layer": ctl.tolist()}


def zamba_recurrence(cfg, params, dev, requests) -> dict:
    """zamba2's chunked prefill against its own recurrence at full width,
    with Mamba2's published decays (:func:`mamba2_decays`) so that state
    crosses chunks. For each request (b, p): a prefill of p − 128 tokens,
    then the last 128 prompt tokens teacher-forced through the graphed
    decode (``_step_fns``: one new capture, the prefill of p − 128 tokens),
    against one prefill of all p tokens (the graph serve_path captured):
    every layer's float32 ``ssm`` state read as :func:`_state_rel`, the
    last logits per row as ‖Δ‖₂/‖·‖₂, each within twice the reading of
    a rounding reference: the one prefill with every Mamba2 input and output
    and every attention output one bf16 step off at every element of the
    last 128 positions, where the two forms differ
    (:func:`mamba2_one_step`). At depth, random weights decorrelate the
    states after any such change, so this end-to-end reading cannot tell a
    fault from rounding; :func:`mamba2_layer_checks` holds each block on a
    shared input, with a control."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS

    gen = torch.Generator(device=dev).manual_seed(29)

    def att(q, k, v, causal):
        return _last_one_step(KERNELS.attention(q, k, v, causal), RECURRENCE_TOKENS, gen)

    rounding = dataclasses.replace(KERNELS, attention=att)

    def states(cache):
        tail = [] if cache["tail"] is None else [cache["tail"]["ssm"]]
        return torch.cat([cache["groups"]["ssm"].flatten(0, 1)] + tail)

    out = []
    with mamba2_decays(params):
        for b, p, g in requests:
            tokens = _tokens(cfg, b, p, dev, 41 + b)
            prefill, decode = S._step_fns(cfg.name, False, b, p + g, dev, donate=True)
            captures0 = dict(S.TRACE_COUNT)
            whole_logits, whole = prefill(params, {"tokens": tokens})
            s_whole = states(whole)
            del whole
            with mamba2_one_step(params, RECURRENCE_TOKENS, gen):
                ref_logits, ref_cache = api.prefill(cfg, params, {"tokens": tokens}, p + g,
                                                    rounding)
            limit = 2 * _state_rel(states(ref_cache), s_whole)
            del ref_cache
            head = p - RECURRENCE_TOKENS
            logits, cache = prefill(params, {"tokens": tokens[:, :head]})
            for t in range(head, p):
                logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
            rec = _state_rel(states(cache), s_whole)
            del cache, s_whole
            out.append({"batch": b, "prompt": p, "chunks": p // 128,
                        "decode_steps": RECURRENCE_TOKENS, "layers": len(limit),
                        "state_largest_share_of_limit": float((rec / limit).max()),
                        "state_rel_max": float(rec.max()),
                        "state_limit_min_max": [float(limit.min()), float(limit.max())],
                        "state_rel_by_layer": rec.tolist(),
                        "state_limit_by_layer": limit.tolist(),
                        "logits_row_rel_max": float(_row_rel(logits, whole_logits).max()),
                        "logits_limit": 2 * float(_row_rel(ref_logits, whole_logits).max()),
                        "new_captures": {k: S.TRACE_COUNT[k] - captures0[k]
                                         for k in captures0}})
        layers = mamba2_layer_checks(cfg, params, dev, requests[0], gen)
    torch.cuda.synchronize()
    row = {"phase": "zamba_chunked_prefill_vs_recurrence", "arch": cfg.name, "requests": out,
           "layer_checks": layers,
           "decays": "Mamba2's initialisation: A in U[1, 16], dt log-uniform in [1e-3, 1e-1]",
           "reading": "per layer max|Δssm|/max|ssm| of the one prefill; last logits per row "
                      "‖Δ‖₂/‖·‖₂",
           "limit": "2 x the reading of a rounding reference with every element of the last "
                    f"{RECURRENCE_TOKENS} positions one bf16 step off: end to end, every Mamba2 "
                    "input and output and every attention output; a layer alone, its input",
           "control": f"a layer alone, the last chunk's log-decays x (1 + {RECURRENCE_CONTROL})"}
    emit(row)
    for r in out:
        if (r["state_largest_share_of_limit"] > 1.0 or r["logits_row_rel_max"] > r["logits_limit"]
                or r["new_captures"] != {"prefill": 1, "decode": 0}):
            raise AssertionError(f"{cfg.name}: chunked prefill off its recurrence: {r}")
    if layers["state_largest_share_of_limit"] > 1.0:
        raise AssertionError(f"{cfg.name}: a Mamba2 block's chunked pass off its recurrence")
    if layers["control_smallest_share_of_limit"] <= 1.0:
        raise AssertionError(f"{cfg.name}: the decay control passed the layer check: the "
                             "check does not discriminate")
    return {"requests": [{k: v for k, v in r.items() if not k.endswith("_by_layer")}
                         for r in out],
            "layer_checks": {k: v for k, v in layers.items() if not k.endswith("_by_layer")}}


def zoo_planned(cfg, params, dev, workdir: Path) -> tuple:
    """``cfg``'s time table built by the planner CLI on the sweep kernel for
    its ZOO_PLANNED request's bucket, then the request served planned on it
    with one power failure (:func:`serve_planned`: tokens equal to
    unplanned serving's). Returns (the build's sweep launches, the planned
    run's kernel launches)."""
    from repro_torch.core.plan_table import PlanTable
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import planner

    (b, p, g), per_cycle, crash_after = ZOO_PLANNED[cfg.name]
    workdir.mkdir(parents=True, exist_ok=True)
    out = workdir / f"{cfg.name}_time.npz"
    sweeps0 = sweep_columns_cuda.launches
    if planner.main(["--arch", cfg.name, "--full", "--device", "cuda", "--buckets",
                     f"{b}x{p + g}", "--out", str(out)]) != 0:
        raise AssertionError(f"the planner CLI failed on {cfg.name}")
    sweeps = sweep_columns_cuda.launches - sweeps0
    if sweeps < 1:
        raise AssertionError(f"{cfg.name}'s table was built without the sweep kernel")
    launches = serve_planned(cfg, params, dev, PlanTable.load(str(out)), (b, p, g), per_cycle,
                             crash_after)
    return sweeps, launches


def zoo_model(arch, layers, requests, dev, workdir: Path) -> tuple:
    """One architecture of the zoo at full width: served through ``serve``
    and the graphed decode (:func:`serve_path`: launches, one capture per
    request shape, the parameters held beside ``param_count()``), every
    prefill flash cell (:func:`flash_cells`, on the random stand-in with
    the vlm gates nonzero), the kernel path against the plain path
    (:func:`zoo_parity`), the graphed decode bitwise equal to eager, a warm
    request's prefill ms and decode ms/token, MoE routing and whisper's
    planned request. Returns ({path: launches}, the planner's sweep
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import register
    from repro_torch.launch import serve as S

    cfg = get_config(arch)
    reduced = None
    if layers is not None:
        reduced = f"n_layers {cfg.n_layers}→{layers}"
        cfg = register(dataclasses.replace(cfg, name=f"{arch}-{layers}-layers", n_layers=layers))
    max_seq = max(p + g for _, p, g in requests)
    pre, step = step_launches(cfg)
    want = {k: sum(pre[k] + (g - 1) * step[k] for _, _, g in requests) for k in pre}
    t0 = time.perf_counter()
    params, launches = serve_path(dev, cfg, requests, (cfg.param_count(), held_params(cfg, max_seq)),
                                  want)
    by_path = {f"zoo {arch}": launches}
    extra = stand_in(cfg, dev) if cfg.family in ("vlm", "encdec") else None
    with cross_gates(params, ZOO_GATE if extra else None):
        cells = flash_cells(cfg, params, dev, requests, extra)
    parity = zoo_parity(cfg, params, dev, requests, extra)
    graphs = serve_step_graphs(cfg, params, dev, requests[0])
    trace = serve_trace(cfg, params, dev, requests[0])
    pre_graphs = serve_prefill_graphs(cfg, params, dev, requests, trace, extra)
    b, p, g = requests[0]
    warm = {}
    S.serve(cfg.name, b, p, g, smoke=False, seed=0, device=dev, params=params, report=warm)
    routing = moe_routing(cfg, params, dev, requests[0]) if cfg.family == "moe" else None
    recurrence = zamba_recurrence(cfg, params, dev, requests) if cfg.family == "hybrid" else None
    sweeps = 0
    if arch in ZOO_PLANNED:
        sweeps, by_path[f"zoo {arch} planned"] = zoo_planned(cfg, params, dev, workdir)
    n_params = sum(t.numel() for t in params.parameters())
    emit({"phase": "zoo", "arch": arch, "reduced": reduced, "family": cfg.family,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "requests": [list(r) for r in requests],
          "param_count": cfg.param_count(), "parameters_held": n_params,
          "weights_gib": sum(t.numel() * t.element_size() for t in params.parameters()) / 2 ** 30,
          "prefill_ms": warm["prefill_ms"], "decode_ms_per_token": warm["decode_ms_per_token"],
          "prefill_device_busy_s": trace["device_busy_s"], "prefill_idle_share": trace["idle_share"],
          "graphed_prefill_host_s": pre_graphs["graphed"]["host_s"],
          "graphed_prefill_idle_share": pre_graphs["graphed"]["idle_share"],
          "graph_decode_bitwise_steps": [graphs["bitwise_equal_steps"], graphs["steps"]],
          "flash_cells": sum(r["cells"] for r in cells),
          "flash_cells_by_kind": [r["cells_by_kind"] for r in cells],
          "flash_largest_share_of_bound": max(r["largest_share_of_bound"] for r in cells),
          "flash_control_smallest_share": min(r["control_smallest_share"] for r in cells),
          "parity": parity["requests"], "parity_limit": parity["limit"],
          "moe_dropped_share": routing and routing["dropped_share"],
          "moe_first_layer_own_input_equal_route_share":
              routing and routing["first_layer_own_input_equal_route_share"],
          "chunked_prefill_vs_recurrence": recurrence,
          "planned_sweep_launches": sweeps, "launches": by_path,
          "seconds": time.perf_counter() - t0})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return by_path, sweeps


def zoo_path(dev, workdir: Path) -> tuple:
    """The eight architectures of ZOO, one after another, each freed before
    the next. Returns ({path: launches}, {planned table: its build's sweep
    launches})."""
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "zoo_start", "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30})
    t0 = time.perf_counter()
    by_path, sweeps = {}, {}
    for arch, layers, requests in ZOO:
        paths, n = zoo_model(arch, layers, requests, dev, workdir)
        by_path.update(paths)
        if n:
            sweeps[f"zoo {arch} table"] = n
    emit({"phase": "zoo_done", "seconds": time.perf_counter() - t0,
          "archs": [a for a, _, _ in ZOO]})
    return by_path, sweeps


# -- training ---------------------------------------------------------------------
#
# The loss runs the plain versions (PLAIN) on the card as on the CPU: repro's
# loss reaches no Pallas kernel, and the CUDA kernels have no backward. The
# card's gradients are held to the CPU's within the tolerance of
# tests/test_torch_loss.py, counted by grad_sites below (a copy of
# tests/helpers_torch.py's count, which this script cannot import): a leaf
# within n·U·max|CPU leaf|, n = 2·n_fwd + 1 + r; the CE within
# 2·n_fwd·U·max|logits|. The control (labels shifted by one position) must
# exceed the leaf tolerance somewhere.

TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_RUN = (50, 8, 128, 20)          # repro's CLI defaults: steps, batch, seq, burst steps
TRAIN_DEPTH = 11                      # of tinyllama's 22 layers in that run: its commits
                                      # (3 of 13.2 GB at 22) set the phase's time
TRAIN_SMOKE_BATCH = (2, 16)
TRAIN_WIDE = (2, 2, 128)              # layers of tinyllama at full width, batch, seq
TRAIN_XLSTM = ("xlstm-1.3b", 4, 8, 128)   # arch, steps (one burst), batch, seq
TRAIN_GRAPH_STEPS = 4                 # the graphed step's warm-up and three replays
TRAIN_GRAPH_WIDE = (22, 8, 128)       # tinyllama-1.1b at full width: layers, batch, seq
TRAIN_MAX_LOSS_S = 60.0
TRAIN_DISK_BYTES = 40e9               # two kept checkpoints and a temporary file
TRAIN_RESUME = ["--arch", "qwen1.5-0.5b", "--steps", "6", "--batch", "2", "--seq", "16",
                "--burst-steps", "2", "--device", "cuda"]
U_SITE = 2.0 ** -9


def forward_sites(cfg) -> int:
    """bf16 rounding sites from the tokens to the logits (the serving
    tests' counts; tests/helpers_torch.py)."""
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
    """2·n_fwd + 1 + r: the backward mirrors each forward site, the leaf's
    weight-gradient product rounds once, and r counts bf16 additions of a
    weight's gradients past its first use (the tied head, a moe router's
    second read for the load-balance loss, zamba2's shared block after its
    first group, an embedding row per repeat of its token)."""
    reuse = int(torch.bincount(tokens.reshape(-1).cpu()).max()) - 1
    reuse += 1 if cfg.tie_embeddings or cfg.family == "moe" else 0
    if cfg.family == "hybrid":
        reuse += cfg.n_layers // cfg.attn_every - 1
    return 2 * forward_sites(cfg) + 1 + reuse


def train_batch(cfg, batch, seq, dev, index=0, seed=1):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticData
    from repro_torch.launch.train import batch_tensors

    data = SyntheticData(SyntheticConfig(cfg.vocab, seq, batch, seed=seed))
    return batch_tensors(cfg, data.batch(index), dev)


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


def loss_and_grads(cfg, model, batch) -> dict:
    """One loss and backward of the plain path: {"loss", "ce", "logits_max",
    "grads": {name: float32 on the CPU}}."""
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN

    model.zero_grad(set_to_none=True)
    with logits_seen() as seen:
        loss, ce = api.loss(cfg, model, batch, remat=True, kernels=PLAIN)
    loss.backward()
    grads = {n: p.grad.detach().to("cpu", torch.float32) for n, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "ce": float(ce.detach()), "logits_max": seen[0],
            "grads": grads}


def grad_shares(got, want, sites) -> dict:
    """{name: max |Δ| / (sites·U·max|want|)} per leaf (0 where both are 0)."""
    out = {}
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        tol = sites * U_SITE * float(w.abs().max())
        out[name] = err / tol if tol > 0 else (0.0 if err == 0 else math.inf)
    return out


def card_vs_cpu(cfg, model, batch, dev) -> dict:
    """``model`` and ``batch`` on the CPU: their loss and gradients there,
    then on a copy on the card, within the tolerance; the control (labels
    shifted by one, on the card) must exceed it. Returns the readings."""
    want = loss_and_grads(cfg, model, batch)
    model.zero_grad(set_to_none=True)
    on_card = copy.deepcopy(model).to(dev)
    batch_d = {k: v.to(dev) for k, v in batch.items()}
    got = loss_and_grads(cfg, on_card, batch_d)
    sites = grad_sites(cfg, batch["tokens"])
    shares = grad_shares(got["grads"], want["grads"], sites)
    ctl = loss_and_grads(cfg, on_card, dict(batch_d, labels=torch.roll(batch_d["labels"], 1, 1)))
    control = grad_shares(ctl["grads"], want["grads"], sites)
    ce_tol = 2 * forward_sites(cfg) * U_SITE * want["logits_max"]
    aux_tol = forward_sites(cfg) * U_SITE * abs(want["loss"] - want["ce"]) + ce_tol
    row = {"sites": sites, "leaves": len(shares), "largest_share": max(shares.values()),
           "worst_leaf": max(shares, key=shares.get),
           "control_largest_share": max(control.values()),
           "ce_card": got["ce"], "ce_cpu": want["ce"],
           "ce_share": abs(got["ce"] - want["ce"]) / ce_tol,
           "loss_card": got["loss"], "loss_cpu": want["loss"]}
    ok = (row["largest_share"] <= 1.0 and row["control_largest_share"] > 1.0
          and row["ce_share"] <= 1.0
          and abs((got["loss"] - got["ce"]) - (want["loss"] - want["ce"])) <= aux_tol
          and all(bool(torch.isfinite(g).all()) for g in got["grads"].values()))
    del on_card
    if not ok:
        raise AssertionError(f"{cfg.name}: card gradients off the CPU's: {row}")
    return row


def step_breakdown(cfg, dev, batch, seq, parts: bool = True) -> dict:
    """A warm training step of ``cfg`` at full width from a fresh model,
    graphed (``_GraphedTrainStep``) and eager (``train_step``) on the same
    model and state, each call a real step: each path's host time, the
    card's busy time and idle share, device ops and largest kernels
    (:func:`one_call`); the graph's capture (recording and instantiation
    seconds, pool bytes) and the host time of the shape's first call (the
    eager warm-up and the capture). With ``parts``, the GEMMs' share of the
    eager step's busy time, and its loss-and-backward and AdamW update
    (with the cast into the module) timed apart."""
    from repro_torch.launch import train as T
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    model, masters = api.init_trainable(cfg, 0, dev, max_seq=seq)
    state = {"params": masters, "opt_state": adamw_init(masters)}
    adamw = AdamWConfig(lr=1e-3, warmup_steps=20)
    b = train_batch(cfg, batch, seq, dev)
    graphed = T._GraphedTrainStep(cfg, adamw, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed(model, state, b)
    torch.cuda.synchronize()
    row = {"first_call_s": time.perf_counter() - t0,
           "capture": next(iter(graphed.graphs(model).values())).stats,
           "graphed": one_call(lambda: graphed(model, state, b)),
           "eager": one_call(lambda: T.train_step(cfg, model, state, adamw, b)),
           "parameters": sum(p.numel() for p in model.parameters())}
    if parts:
        rows = profile_device(lambda: T.train_step(cfg, model, state, adamw, b))
        gemm = sum(t for k, (t, _) in rows.items()
                   if any(w in k.lower() for w in ("gemm", "nvjet", "cutlass", "xmma")))
        busy = sum(t for t, _ in rows.values())

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            api.loss(cfg, model, b, remat=True, kernels=PLAIN)[0].backward()

        fwd_bwd_ms = cuda_ms(fwd_bwd, 3)
        grads = {n: p.grad for n, p in model.named_parameters()}

        def update():
            adamw_update(adamw, state["params"], grads, state["opt_state"])
            api.load_masters(model, state["params"])

        row.update(gemm_share_of_busy=gemm / busy if busy else None, fwd_bwd_ms=fwd_bwd_ms,
                   adamw_and_cast_ms=cuda_ms(update, 3))
        del grads
    del model, masters, state, graphed
    gc.collect()
    torch.cuda.empty_cache()
    return row


def state_leaves(state) -> dict:
    """{name: tensor} of a train state: every master, m, v and the counter."""
    out = {f"params.{k}": v for k, v in state["params"].items()}
    for part in ("m", "v"):
        out.update({f"{part}.{k}": v for k, v in state["opt_state"][part].items()})
    out["step"] = state["opt_state"]["step"]
    return out


def run_steps(cfg, dev, seq, batches, how: str) -> tuple:
    """A fresh model and state from seed 0, then one step per batch, ``how``:
    "eager" (``train_step``), "graphed" (``_GraphedTrainStep``: the first
    call its warm-up and capture, the others replays) or "frozen" (eager
    steps with the counter set back after every step but the first, as a
    graph that captured a rebound counter would leave it). Returns (state,
    the losses as one tensor on the card, the capture's stats or None)."""
    from repro_torch.launch import train as T
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    model, masters = api.init_trainable(cfg, 0, dev, max_seq=seq)
    state = {"params": masters, "opt_state": adamw_init(masters)}
    adamw = AdamWConfig(lr=1e-3, warmup_steps=20)
    graphed = T._GraphedTrainStep(cfg, adamw, dev)
    counter = state["opt_state"]["step"]
    losses = []
    for i, b in enumerate(batches):
        if how == "graphed":
            losses.append(graphed(model, state, b))
            continue
        before = counter.clone()
        losses.append(T.train_step(cfg, model, state, adamw, b))
        if how == "frozen" and i:
            counter.copy_(before)
    stats = ([cap.stats for cap in graphed.graphs(model).values()]
             if how == "graphed" else None)
    return state, torch.stack(losses), stats


def train_graph_parity(cfg, dev, batch, seq) -> dict:
    """The graphed step against the eager step from the same start over
    TRAIN_GRAPH_STEPS seeded batches: an eager run, then a second eager run
    (the eager step must repeat itself bitwise on the card), the graphed
    run (losses and every master, m, v and the counter bitwise the first
    run's; one capture) and the control, the frozen counter, which must
    differ from it in the masters or moments. Returns the reading."""
    batches = [train_batch(cfg, batch, seq, dev, index=i, seed=0)
               for i in range(TRAIN_GRAPH_STEPS)]
    want, want_losses, _ = run_steps(cfg, dev, seq, batches, "eager")
    want_leaves = state_leaves(want)
    row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [batch, seq],
           "leaves": len(want_leaves), "losses": want_losses.tolist()}
    for how in ("eager", "graphed", "frozen"):
        got, losses, stats = run_steps(cfg, dev, seq, batches, how)
        diff = [k for k, t in state_leaves(got).items() if not torch.equal(t, want_leaves[k])]
        row[how] = {"losses_equal": bool(torch.equal(losses, want_losses)),
                    "differing_leaves": len(diff), "first_differing": diff[:4]}
        if stats is not None:
            row["captures"] = stats
        del got, losses
        gc.collect()
        torch.cuda.empty_cache()
    del want, want_leaves
    gc.collect()
    torch.cuda.empty_cache()
    row["ok"] = (all(row[h]["losses_equal"] and not row[h]["differing_leaves"]
                     for h in ("eager", "graphed"))
                 and len(row["captures"]) == 1
                 and any(k != "step" for k in row["frozen"]["first_differing"]))
    return row


def train_graphs(dev) -> dict:
    """The ``train_graphs`` phase: :func:`train_graph_parity` for the ten
    smoke configs (TRAIN_SMOKE_BATCH) and tinyllama-1.1b at full width
    (TRAIN_GRAPH_WIDE). Raises on any row that fails."""
    from repro_torch.configs import SMOKE_CONFIGS, get_config
    from repro_torch.launch import train as T

    t0 = time.perf_counter()
    trace0 = T.TRACE_COUNT["step"]
    rows = [train_graph_parity(cfg, dev, *TRAIN_SMOKE_BATCH) for cfg in SMOKE_CONFIGS.values()]
    layers, b, seq = TRAIN_GRAPH_WIDE
    wide = get_config(TRAIN_ARCH)
    if layers != wide.n_layers:
        wide = dataclasses.replace(wide, n_layers=layers)
    rows.append(train_graph_parity(wide, dev, b, seq))
    captures = T.TRACE_COUNT["step"] - trace0
    row = {"phase": "train_graphs", "seconds": time.perf_counter() - t0,
           "steps": TRAIN_GRAPH_STEPS, "captures": captures, "rows": rows}
    emit(row)
    if not all(r["ok"] for r in rows) or captures != len(rows):
        raise AssertionError("train: the graphed step is not the eager step: "
                             + json.dumps([r for r in rows if not r["ok"]]))
    return row


def backward_candidates(dev) -> dict:
    """Forward and backward of the plain RMSNorm and attention that the
    training path runs, at tinyllama-1.1b's b8 × 128 shapes, beside the
    library calls a backward kernel would be held against (timed here only),
    and of the plain mLSTM cell at xlstm-1.3b's: what backward kernels
    could save, per call."""
    import torch.nn.functional as F

    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_plain
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
    from repro_torch.models.common import PLAIN

    gen = torch.Generator(device=dev).manual_seed(3)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype).requires_grad_(True)

    x, w = leaf(1024, 2048), leaf(2048, dtype=torch.float32)
    q, k, v = leaf(8, 128, 32, 64), leaf(8, 128, 4, 64), leaf(8, 128, 4, 64)
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    w_lib = w.detach().to(torch.bfloat16).requires_grad_(True)

    def run(f, *inputs):
        return cuda_ms(lambda: f(*inputs).float().square().sum().backward(), 10)

    # the mLSTM cell of xlstm-1.3b's blocks at b8 × 128: B·H 32, hd 1024, one chunk
    mq, mk, mv = (leaf(32, 128, 1024) for _ in range(3))
    mi, mf = leaf(32, 128, dtype=torch.float32), leaf(32, 128, dtype=torch.float32)
    mlstm_ms = cuda_ms(lambda: mlstm_chunk_plain(mq, mk, mv, mi, mf)[0].float().square()
                       .sum().backward(), 3)
    return {
        "mlstm_plain_fwd_bwd_ms": mlstm_ms,
        "rmsnorm_plain_fwd_bwd_ms": run(lambda a, b: rmsnorm_plain(a, b, 1e-5), x, w),
        "rmsnorm_library_fwd_bwd_ms": run(lambda a, b: F.rms_norm(a, (2048,), b, 1e-5),
                                          x, w_lib),
        "attention_plain_fwd_bwd_ms": run(lambda a, b, c: PLAIN.attention(a, b, c, True),
                                          q, k, v),
        "attention_library_fwd_bwd_ms": run(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), ql, kl, vl),
        "shapes": "rmsnorm [1024, 2048] bf16; attention b8 x 128, H 32, KV 4, hd 64, causal; "
                  "mLSTM B·H 32 x 128, hd 1024, bf16 (no library call)",
    }


def resume_via_cli(workdir: Path) -> dict:
    """The train CLI on the card in two processes, each with
    ``torch.use_deterministic_algorithms(True)`` and
    ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts (the embedding's
    backward accumulates with atomics otherwise): the first runs with
    ``--crash-after-burst 1`` and must exit 1 right after burst 1 commits;
    the second runs the same 6 steps uninterrupted in another directory,
    then the first command again, which resumes from burst 1. Its 4 losses
    must equal the uninterrupted run's last 4 within repro's rtol 1e-6."""
    code = ("import json, sys, torch\n"
            "torch.use_deterministic_algorithms(True)\n"
            "from repro_torch.launch import train as T\n"
            "run = T.train\n"
            "def train(*a, **k):\n"
            "    n = T.TRACE_COUNT['step']\n"
            "    print('LOSSES', json.dumps(run(*a, **k)), flush=True)\n"
            "    print('CAPTURES', T.TRACE_COUNT['step'] - n, flush=True)\n"
            "T.train = train\n"
            "argv = sys.argv[1:]\n"
            "if '--whole' in argv:\n"
            "    argv.remove('--whole')\n"
            "    rc = T.main(argv[:-1] + [argv[-1] + '_whole'])\n"
            "    sys.exit(rc or T.main(argv))\n"
            "sys.exit(T.main(argv))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    ckpt = ["--ckpt-dir", str(workdir / "resume")]

    def cli(*extra):
        out = subprocess.run([sys.executable, "-c", code, *TRAIN_RESUME, *extra, *ckpt],
                             env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        losses = [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
                  if line.startswith("LOSSES ")]
        captures = [int(line.split()[1]) for line in out.stdout.splitlines()
                    if line.startswith("CAPTURES ")]
        return out, losses, captures

    t0 = time.perf_counter()
    crashed, none, _ = cli("--crash-after-burst", "1")
    resumed, runs, captures = cli("--whole")
    want, got = (runs + [None, None])[:2]
    diff = (max(abs(a - b) / abs(b) for a, b in zip(got, want[2:]))
            if got and want and len(got) == 4 and len(want) == 6 else None)
    row = {"uninterrupted": want, "resumed": got, "largest_relative_difference": diff,
           "crash_exit_code": crashed.returncode, "seconds": time.perf_counter() - t0,
           "deterministic_algorithms": True, "captures_per_run": captures}
    ok = (crashed.returncode == 1 and not none and resumed.returncode == 0
          and "[train] burst 1/3 committed" in crashed.stdout
          and "[train] injected crash!" in crashed.stdout
          and "[train] resumed from burst 1 (step 2)" in resumed.stdout
          and diff is not None and diff <= 1e-6 and captures == [1, 1])
    if not ok:
        raise AssertionError(f"train CLI resume: {row}\n{crashed.stderr[-2000:]}\n"
                             f"{resumed.stderr[-2000:]}")
    return row


def disk_free(workdir: Path) -> int:
    """Free bytes under ``workdir``; raises below TRAIN_DISK_BYTES."""
    free = shutil.disk_usage(workdir).free
    if free < TRAIN_DISK_BYTES:
        raise AssertionError(f"train: {free / 1e9:.1f} GB free under {workdir}, "
                             f"{TRAIN_DISK_BYTES / 1e9:.0f} GB needed")
    return free


def in_background(fn):
    """Start ``fn()`` on a thread; returns a function that waits for it and
    gives its result or raises its exception."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # re-raised by the caller on join
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return join


def train_path(dev, workdir: Path) -> tuple:
    """The training path on the card (module docstring, phase 13). The CLI's
    crash and resume run in their own processes beside the checks (every
    family's gradients, full width at 2 layers, the graphed step against the
    eager one, xlstm-1.3b's run); the timed tinyllama-1.1b run and the
    traced steps start after they end. Returns
    ({"train": the model kernels' launches}, the burst-schedule solves'
    sweep launches)."""
    from repro_torch.checkpoint.burst_ckpt import plan_burst_schedule
    from repro_torch.configs import SMOKE_CONFIGS, get_config
    from repro_torch.configs.base import register
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.launch import train as T
    from repro_torch.models import api

    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_start", "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30})
    counters = serving_launches()
    for fn in counters.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    resumed = in_background(lambda: resume_via_cli(workdir))

    # every family at smoke size: the card's gradients against the CPU's
    t0 = time.perf_counter()
    smoke = {}
    for arch, cfg in SMOKE_CONFIGS.items():
        model, _ = api.init_trainable(cfg, 0, cpu, max_seq=TRAIN_SMOKE_BATCH[1])
        smoke[arch] = card_vs_cpu(cfg, model, train_batch(cfg, *TRAIN_SMOKE_BATCH, cpu), dev)
    emit({"phase": "train_smoke_grads", "seconds": time.perf_counter() - t0,
          "batch": list(TRAIN_SMOKE_BATCH), "archs": smoke})

    # tinyllama at full width, 2 of its 22 layers: the gradient against the CPU
    t0 = time.perf_counter()
    layers, b, seq = TRAIN_WIDE
    wide_cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=layers)
    model, _ = api.init_trainable(wide_cfg, 0, cpu, max_seq=seq)
    wide = card_vs_cpu(wide_cfg, model, train_batch(wide_cfg, b, seq, cpu), dev)
    wide["parameters"] = sum(p.numel() for p in model.parameters())
    del model
    emit({"phase": "train_full_width_grads", "arch": TRAIN_ARCH,
          "reduced": f"n_layers 22→{layers}", "batch": [b, seq],
          "seconds": time.perf_counter() - t0, **wide})

    # the graphed step against the eager step, bitwise
    train_graphs(dev)

    # xlstm-1.3b at full width through the graphed train(): one capture, one commit
    arch, n, b, seq = TRAIN_XLSTM
    disk_free(workdir)
    torch.cuda.reset_peak_memory_stats()
    report = {}
    trace0 = T.TRACE_COUNT["step"]
    t0 = time.perf_counter()
    xl = T.train(arch, n, b, seq, n, str(workdir / "xlstm"), smoke=False, device=dev,
                 report=report)
    row = {"phase": "train_xlstm", "arch": arch, "steps": n, "batch": [b, seq], "losses": xl,
           "seconds": time.perf_counter() - t0, "step_seconds": report["step_seconds"],
           "captures": report["captures"], "trace_count": T.TRACE_COUNT["step"] - trace0,
           "commits": report["commits"],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    shutil.rmtree(workdir / "xlstm", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(row)
    if not (len(xl) == n and all(math.isfinite(x) for x in xl) and row["trace_count"] == 1
            and len(row["captures"]) == 1 and len(row["commits"]) == 1):
        raise AssertionError(f"train: xlstm {row}")

    # crash and resume through the CLI (run beside the checks above)
    emit({"phase": "train_resume_cli", **resumed()})

    # tinyllama at full width and TRAIN_DEPTH layers through train(), repro's defaults
    steps, b, seq, burst = TRAIN_RUN
    run_arch = register(dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_DEPTH,
                                            name=f"{TRAIN_ARCH}-{TRAIN_DEPTH}-layers")).name
    free = disk_free(workdir)
    torch.cuda.reset_peak_memory_stats()
    report = {}
    trace0 = T.TRACE_COUNT["step"]
    t0 = time.perf_counter()
    losses = T.train(run_arch, steps, b, seq, burst, str(workdir / "tinyllama"),
                     smoke=False, device=dev, report=report)
    captures = T.TRACE_COUNT["step"] - trace0
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(report["step_seconds"][3:])
    step_s = warm[len(warm) // 2]
    state_bytes = report["commits"][0]["bytes"]
    shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "train_full", "arch": run_arch, "reduced": f"n_layers 22→{TRAIN_DEPTH}",
           "steps": steps, "batch": [b, seq],
           "burst_steps": burst, "seconds": run_s, "first_loss": losses[0],
           "last_loss": losses[-1], "losses": losses,
           "first_step_s": report["step_seconds"][0], "warm_step_ms_median": step_s * 1e3,
           "max_memory_allocated_gib": peak / 2 ** 30, "commits": report["commits"],
           "captures": report["captures"], "trace_count": captures,
           "disk_free_gb_before": free / 1e9}
    emit(row)
    if not (len(losses) == steps and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] and len(report["commits"]) == 3
            and captures == 1 and len(report["captures"]) == 1):
        raise AssertionError(f"train: {row}")

    # where a warm step's time goes, graphed and eager; what backward kernels could save
    emit({"phase": "train_step_trace", "arch": TRAIN_ARCH, "batch": [b, seq],
          **step_breakdown(get_config(TRAIN_ARCH), dev, b, seq),
          "backward_candidates": backward_candidates(dev)})
    arch, _, xb, xseq = TRAIN_XLSTM
    emit({"phase": "train_step_trace", "arch": arch, "batch": [xb, xseq],
          **step_breakdown(get_config(arch), dev, xb, xseq, parts=False)})

    # the checkpoint cadence priced with this run's step time and state bytes
    sweep_columns_cuda.launches = 0
    plans = {be: plan_burst_schedule(steps, step_s, state_bytes, TRAIN_MAX_LOSS_S, backend=be)
             for be in ("numpy", "cuda")}
    sweep_launches = sweep_columns_cuda.launches
    emit({"phase": "train_burst_schedule", "step_seconds": step_s, "state_bytes": state_bytes,
          "max_loss_seconds": TRAIN_MAX_LOSS_S, "sweep_launches": sweep_launches,
          **{f"{be}_summary": p.summary() for be, p in plans.items()},
          "bounds": plans["numpy"].bounds})
    if plans["numpy"].bounds != plans["cuda"].bounds or sweep_launches < 1:
        raise AssertionError("train: the burst schedule differs between numpy and cuda")

    launches = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "train_done", "seconds": time.perf_counter() - t_phase,
          "model_kernel_launches": launches})
    if any(launches.values()):
        raise AssertionError(f"train: the training path launched model kernels: {launches}")
    return {"train": launches}, sweep_launches


# The dry run: every (arch × shape) cell counted on meta on the host in
# worker processes, the cells that fit run on the card; then build_cell at
# shapes the earlier phases serve, counted and run.
DRYRUN_CELLS = 40
DRYRUN_SKIPPED = 8        # long_500k × the eight quadratic architectures, as in repro
DRYRUN_KEYS = ("arch", "shape", "mesh", "family", "status", "t_lower_s", "t_compile_s",
               "n_chips", "memory", "cost_analysis", "collective_bytes_by_kind",
               "collective_count_by_kind", "collective_bytes_total", "roofline", "dominant",
               "model_flops_global", "useful_flops_ratio")
DRYRUN_SERVED = (("qwen3-4b", "prefill", 4, 512), ("qwen3-4b", "decode", 4, 528),
                 ("xlstm-1.3b", "prefill", 4, 512), ("tinyllama-1.1b", "train", 8, 128))


def _held_to_count(where, roofline, step_s, peak, args_bytes, counted_peak) -> dict:
    """The measured step against its count: counted work the card could not
    have done in the measured time is an over-count; the card's peak in the
    eager step (``peak``: the graph's warm-up, before the capture, so the
    graph's private pool is not in it) holds the arguments at least."""
    bound_s = max(roofline["t_compute"], roofline["t_memory"])
    if bound_s > step_s:
        raise AssertionError(f"dryrun {where}: the roofline bound {bound_s} s exceeds the "
                             f"measured step {step_s} s: the count over-counts")
    if peak < args_bytes:
        raise AssertionError(f"dryrun {where}: the card's peak {peak} B is below the "
                             f"counted arguments {args_bytes} B")
    return {"bound_s": bound_s, "step_s": step_s, "bound_share": bound_s / step_s,
            "peak_bytes": peak, "peak_over_counted": peak / counted_peak}


def dryrun_path(dev, workdir: Path) -> dict:
    """``dryrun.main(["--all", ...])``: 40 records, 8 skipped, 0 errors,
    each with repro's keys, every measured cell within its roofline bound;
    then each DRYRUN_SERVED shape through ``build_cell``: a CUDA graph (the
    measured step a replay), its counted kernel calls equal to the card's
    launches for the same step and to ``step_launches``, its bound and peak
    held as above, the graph's pool beside the peak. Returns the launches
    of the phase."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.launch.steps import build_cell

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    counters = serving_launches()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = dryrun.main(["--all", "--device", "cuda", "--out", str(workdir)])
    all_s = time.perf_counter() - t0
    recs = [json.loads(p.read_text()) for p in sorted(workdir.glob("*.json"))]
    status = [r["status"] for r in recs]
    skipped = sorted((r["arch"], r["shape"]) for r in recs if r["status"] == "skipped")
    if (rc != 0 or len(recs) != DRYRUN_CELLS or status.count("error")
            or len(skipped) != DRYRUN_SKIPPED
            or any(shape != "long_500k" or get_config(a).is_subquadratic
                   for a, shape in skipped)):
        raise AssertionError(f"dryrun --all: exit {rc}, {len(recs)} records, "
                             f"{status.count('error')} errors, skipped {skipped}: "
                             f"{[r.get('error') for r in recs if r['status'] == 'error']}")
    missing = {(r["arch"], r["shape"]): [k for k in DRYRUN_KEYS if k not in r]
               for r in recs if r["status"] == "ok"}
    if any(missing.values()):
        raise AssertionError(f"dryrun records without repro's keys: {missing}")
    measured = {}
    for r in recs:
        if "measured" in r:
            m, mem = r["measured"], r["memory"]
            if not m["graphed"]:
                raise AssertionError(f"dryrun {r['arch']} {r['shape']}: measured eager")
            measured[f"{r['arch']} {r['shape']}"] = {
                "graphed": True, "pool_bytes": m["pool_bytes"],
                "graphed_peak_bytes": m["peak_bytes"], **_held_to_count(
                    f"{r['arch']} {r['shape']}", r["roofline"], m["step_s"],
                    m["eager_peak_bytes"], mem["argument_size_in_bytes"],
                    mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])}
    fits = sorted(f"{r['arch']} {r['shape']}" for r in recs if r.get("fits"))
    if sorted(measured) != fits:
        raise AssertionError(f"dryrun: cells that fit {fits}, measured {sorted(measured)}")
    all_launches = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "dryrun_all", "seconds": all_s,
          "count_workers": len(os.sched_getaffinity(0)), "records": len(recs),
          "ok": status.count("ok"), "skipped": len(skipped), "errors": 0, "fits": fits,
          "measured": measured, "launches": all_launches,
          "count_s": {f"{r['arch']} {r['shape']}": r["t_compile_s"]
                      for r in recs if r["status"] == "ok"},
          "cards_needed": {f"{r['arch']} {r['shape']}": r["cards_needed"]
                           for r in recs if r["status"] == "ok"}})

    served = {}
    for arch, kind, b, seq in DRYRUN_SERVED:
        cfg = get_config(arch)
        cell = build_cell(cfg, ShapeConfig(f"{kind}_b{b}_s{seq}", seq, b, kind), dev)
        t0 = time.perf_counter()
        _, stats = cell.count()
        count_s = time.perf_counter() - t0
        counted = {k: stats.kernel_calls.get(k, 0) for k in counters}
        pre, step = step_launches(cfg)
        want = {"prefill": pre, "decode": step, "train": dict.fromkeys(counters, 0)}[kind]
        m = dryrun.measure(cell, 0, lambda: {k: fn.launches for k, fn in counters.items()})
        name = f"{arch} {kind} b{b} x {seq}"
        if not (counted == m["launched"] == want):
            raise AssertionError(f"dryrun {name}: counted kernel calls {counted}, the card "
                                 f"launched {m['launched']}, step_launches {want}")
        if not m["graphed"]:
            raise AssertionError(f"dryrun {name}: the measured step was not a graph replay")
        # the floor holds the eager step's own peak (the warm-up, before the
        # capture); the peak over warm-up, capture and replay, which holds the
        # graph's pool too, is printed beside it
        served[name] = {"kernel_calls": counted, "count_s": count_s, "graphed": True,
                        "first_step_s": m["first_step_s"], "flops": stats.flops,
                        "bytes": stats.bytes, "pool_bytes": m["pool_bytes"],
                        "graphed_peak_bytes": m["peak_bytes"],
                        "graphed_peak_over_counted": m["peak_bytes"] / stats.peak_bytes,
                        **_held_to_count(name, roofline_terms(stats.flops, stats.bytes, 0.0),
                                         m["step_s"], m["eager_peak_bytes"],
                                         stats.argument_bytes, stats.peak_bytes)}
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in counters.items()}
    emit({"phase": "dryrun_served", "seconds": time.perf_counter() - t_phase,
          "cells": served, "launches": launches})
    return launches


# The sharded phase: repro's model sharding on a torch DeviceMesh.
# One card: qwen3-4b's prefill of SHARDED_PREFILL and SHARDED_DECODE_STEPS
# teacher-forced decode steps, and SHARDED_TRAIN_STEPS SHARDED_TRAIN steps,
# through build_cell(..., mesh=make_host_mesh()) on a one-process NCCL
# group, each cell eager and as a CUDA graph, both bitwise the unsharded
# cell's; with more cards, the prefill on a (1, n) mesh too; then the dry
# run per device of repro's production meshes on SHARDED_DRYRUN_ARCHS,
# within SHARDED_DRYRUN_BUDGET_S.
SHARDED_PREFILL = (4, 512)
SHARDED_DECODE_STEPS = 8
SHARDED_TRAIN = ("tinyllama-1.1b", 8, 128)
SHARDED_TRAIN_STEPS = 2   # the graphed cell's capture, then a replay
# the train CLI's step on the one-card mesh (--production-mesh's path):
# arch (smoke), steps, batch, seq, burst steps, whole and on the mesh
SHARDED_CLI = ("tinyllama-1.1b", 4, 8, 128, 4)
# a full-width MoE prefill (arch, batch, prompt) through the sharded bundle's
# experts on the one-card mesh, bitwise the unsharded cell
SHARDED_MOE = ("granite-moe-1b-a400m", 4, 512)
# --multi-card: after qwen3-4b, this MoE model whole (every layer) on a (1, n)
# mesh of the n cards, its experts split over "model"
MULTI_CARD_MOE = ("phi3.5-moe-42b-a6.6b", 4, 512)
SHARDED_DRYRUN_ARCHS = ("qwen3-4b", "granite-moe-1b-a400m", "xlstm-1.3b")
# The sharded dry run counts on the host only (a fake process group, meta
# tensors): it starts after the build, in a process of its own on half of
# the CPUs (this process keeps the other half), beside the card phases, and
# must end within this many seconds
SHARDED_DRYRUN_BUDGET_S = 900.0
SHARDED_SKIPPED = 4       # long_500k of qwen3-4b and granite, on each mesh
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter", "all_reduce": "all-reduce",
                    "shard_dim_alltoall": "all-to-all", "all_to_all_single": "all-to-all"}


def _whole(t):
    """A DTensor's whole value (its block on a one-device mesh), a tensor as
    it is."""
    from repro_torch.models.sharding import is_dtensor

    if not is_dtensor(t):
        return t
    return t.to_local() if t.device_mesh.size() == 1 else t.full_tensor()


def _timed(fn):
    """(``fn()``, its host seconds from a synchronized card to the next
    synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_serving(cfg, dev, mesh, eager: bool = False) -> tuple:
    """qwen3-4b's prefill of SHARDED_PREFILL (its cache padded for the
    decode; twice, the second warm) and SHARDED_DECODE_STEPS decode steps on
    fixed tokens, through ``build_cell`` cells (``mesh`` None: whole) with
    ``CellSpec.run`` (on the card a graph: the first prefill and the first
    step capture) or, with ``eager``, ``CellSpec.run_eager`` → (each
    step's logits and the final cache, whole; the host ms of the first and
    the warm prefill and decode step, the median of the steps after the
    first)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_cell, shard_batch

    b, p = SHARDED_PREFILL
    n = SHARDED_DECODE_STEPS
    pre = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), dev, mesh=mesh,
                     max_seq=p + n)
    args = pre.materialize(0)
    run = pre.run_eager if eager else pre.run
    _, first_s = _timed(lambda: run(args))
    (logits, cache), warm_s = _timed(lambda: run(args))
    dec = build_cell(cfg, ShapeConfig("decode", p + n, b, "decode"), dev, mesh=mesh)
    step = dec.run_eager if eager else dec.run
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (n, b, 1), generator=gen, device=dev)
    out, step_s = [logits], []
    for j in range(n):
        tok = tokens[j] if mesh is None else shard_batch(cfg, {"t": tokens[j]}, mesh)["t"]
        pos = torch.tensor(p + j, device=dev)
        (lg, cache), s = _timed(lambda: step((args[0], cache, tok, pos)))
        out.append(lg)
        step_s.append(s)
    ms = {"prefill_first_ms": first_s * 1e3, "prefill_warm_ms": warm_s * 1e3,
          "decode_first_ms": step_s[0] * 1e3,
          "decode_warm_ms": float(np.median(step_s[1:])) * 1e3}
    return ({"logits": [_whole(t) for t in out],
             "cache": {k: _whole(v) for k, v in cache.items()}}, ms)


def sharded_prefill(cfg, dev, mesh, b, p, eager: bool = False) -> tuple:
    """``cfg``'s prefill of b × p through a ``build_cell`` cell (``mesh``
    None: whole), twice, with ``CellSpec.run`` (or ``run_eager``) → (the
    second's logits and cache, whole; the host ms of each)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_cell

    cell = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), dev, mesh=mesh)
    args = cell.materialize(0)
    run = cell.run_eager if eager else cell.run
    _, first_s = _timed(lambda: run(args))
    (logits, cache), warm_s = _timed(lambda: run(args))
    return ({"logits": _whole(logits), "cache": {k: _whole(v) for k, v in cache.items()}},
            {"first_ms": first_s * 1e3, "warm_ms": warm_s * 1e3})


def sharded_train(cfg, dev, mesh, b, s, eager: bool = False) -> tuple:
    """SHARDED_TRAIN_STEPS train steps of ``cfg`` at b × s on one batch
    through a ``build_cell`` cell, with ``CellSpec.run`` (on the card a
    graph: the first step its capture) or ``run_eager`` → (each loss, the
    masters and the moments after them, whole; the host ms of the first
    and the last step)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_cell

    cell = build_cell(cfg, ShapeConfig("train", s, b, "train"), dev, mesh=mesh)
    model, state, batch = cell.materialize(0)
    run = cell.run_eager if eager else cell.run
    losses, secs = [], []
    for _ in range(SHARDED_TRAIN_STEPS):
        loss, t = _timed(lambda: run((model, state, batch)))
        losses.append(_whole(loss))
        secs.append(t)
    opt = state["opt_state"]
    return ({"loss": losses, "masters": {k: _whole(v) for k, v in state["params"].items()},
             "m": {k: _whole(v) for k, v in opt["m"].items()},
             "v": {k: _whole(v) for k, v in opt["v"].items()}},
            {"first_ms": secs[0] * 1e3, "warm_ms": secs[-1] * 1e3})


def _bitwise(where, got, want) -> int:
    """Raises unless every tensor of ``got`` equals ``want``'s bit for bit;
    returns how many were compared."""
    if isinstance(want, dict):
        return sum(_bitwise(f"{where}.{k}", got[k], v) for k, v in want.items())
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"sharded {where}: {len(got)} tensors, want {len(want)}")
        return sum(_bitwise(f"{where}[{i}]", g, w) for i, (g, w) in enumerate(zip(got, want)))
    if not torch.equal(got, want):
        raise AssertionError(f"sharded {where}: not bitwise the reference cell's "
                             f"(max |Δ| {float((got.float() - want.float()).abs().max())})")
    return 1


def _comm_kinds(counts) -> dict:
    out = {}
    for op, n in counts.items():
        kind = COLLECTIVE_KINDS[str(op).split(".")[-1]]
        out[kind] = out.get(kind, 0) + n
    return out


MULTI_CARD_REPS = 3   # warm eager steps and replays timed on the cards, the least kept
# the n worker processes of a --multi-card run: the seconds they may take in
# all, and after process 0 wrote the result, the seconds left for the group's
# teardown before the processes are stopped (the line says whether they were)
MULTI_CARD_LIMIT_S = 300.0
MULTI_CARD_TEARDOWN_S = 60.0


def _save_result(obj, path) -> None:
    """``torch.save`` to ``path`` whole: written beside it, then renamed."""
    tmp = f"{path}.part"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _run_workers(worker, n: int, store: Path, out_path: Path) -> tuple:
    """``worker(rank, n, store, out_path)`` in n spawned processes → (the
    result process 0 saved at ``out_path``, how the processes ended:
    "exited", or "stopped" when they were still in the group's teardown
    MULTI_CARD_TEARDOWN_S after the result was written). Raises when a
    process fails, or when no result came within MULTI_CARD_LIMIT_S; every
    process is stopped before it returns or raises."""
    import torch.multiprocessing as mp

    for f in (store, out_path):
        f.unlink(missing_ok=True)
    ctx = mp.start_processes(worker, args=(n, str(store), str(out_path)), nprocs=n,
                             start_method="spawn", join=False)
    t0, written, ended = time.monotonic(), None, "exited"
    try:
        while not ctx.join(timeout=2.0):
            now = time.monotonic()
            if written is None and out_path.exists():
                written = now
            if written is not None and now - written > MULTI_CARD_TEARDOWN_S:
                ended = "stopped"
                break
            if written is None and now - t0 > MULTI_CARD_LIMIT_S:
                raise AssertionError(f"{worker.__name__}: no result in {MULTI_CARD_LIMIT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return torch.load(out_path), ended


@contextlib.contextmanager
def comm_debug(model):
    """``CommDebugMode`` over a run of ``model``; on exit the forward hooks
    its module tracker left on ``model``'s modules are removed (torch 2.11
    leaves some behind, and they raise when the module runs outside the
    mode)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import _CommModeModuleTracker

    try:
        with CommDebugMode() as comm:
            yield comm
    finally:
        for mod in model.modules():
            for key, hook in list(mod._forward_hooks.items()):
                if isinstance(getattr(hook, "__self__", None), _CommModeModuleTracker):
                    del mod._forward_hooks[key]


def graph_on_mesh(cell, args) -> dict:
    """A prefill cell on its mesh of cards, in each of the mesh's processes:
    MULTI_CARD_REPS warm eager steps (``run_eager``, after one untimed),
    then ``run``'s capture and MULTI_CARD_REPS replays. Returns the last
    eager and the last replayed logits, whole (gathered outside the timed
    calls), the collectives ``CommDebugMode`` saw while the graph was
    captured (the capture records them, and each replay launches what it
    recorded; the warm-up before it is not counted), the least host ms of
    each, the first call's seconds and the capture's stats."""
    fn, seen = cell.fn, {}

    def counted(*a, **k):
        if not torch.cuda.is_current_stream_capturing():
            return fn(*a, **k)
        with comm_debug(args[0]) as comm:
            out = fn(*a, **k)
        seen.update(_comm_kinds(comm.get_comm_counts()))
        return out

    out = {}
    cell.fn = counted
    for key, run in (("eager", cell.run_eager), ("graphed", cell.run)):
        _, first_s = _timed(lambda: run(args))
        secs = []
        for _ in range(MULTI_CARD_REPS):
            (logits, _), t = _timed(lambda: run(args))
            secs.append(t)
        out[key] = {"logits": logits.full_tensor(), "first_s": first_s,
                    "warm_ms": min(secs) * 1e3, "ms": [t * 1e3 for t in secs]}
        del logits
    cell.fn = fn
    caps = list(cell.graphs(args[0]).values())
    if len(caps) != 1:
        raise AssertionError(f"{len(caps)} captures of one prefill cell and shape")
    out["collectives"] = seen
    out["capture"] = caps[0].stats
    return out


REDUCTIONS = ("all-reduce", "reduce-scatter")


def graphed_line(res, counted, limit: float) -> dict:
    """The graphed prefill on the cards against its eager steps: the
    replay's logits bitwise the eager ones, or, where they differ, every
    row within ``limit`` (the cell's existing limit) of them, the cell's
    reductions named as the collectives that may order their sums
    otherwise in a graph; the capture's collectives the count's."""
    eager, graphed = res["eager"], res["graphed"]
    same = torch.equal(eager["logits"], graphed["logits"])
    line = {"bitwise": same, "collectives": res["collectives"],
            "eager_warm_ms": eager["warm_ms"], "graphed_warm_ms": graphed["warm_ms"],
            "eager_ms": eager["ms"], "graphed_ms": graphed["ms"],
            "eager_first_s": eager["first_s"], "capture_first_s": graphed["first_s"],
            "capture": res["capture"]}
    if not same:
        rel = float(_row_rel(graphed["logits"], eager["logits"]).max())
        line.update({"max_row_rel": rel, "limit": limit,
                     "reductions": {k: n for k, n in counted.items() if k in REDUCTIONS}})
        if rel > limit or not line["reductions"]:
            raise AssertionError(f"graphed prefill on the cards: a replay's logits differ from "
                                 f"the eager step's, row rel {rel} (limit {limit}), the cell's "
                                 f"reductions {line['reductions']}")
    if res["collectives"] != counted:
        raise AssertionError(f"graphed prefill on the cards: the capture recorded "
                             f"{res['collectives']}, the count {counted}")
    return line


def _multi_card_worker(rank: int, n: int, store: str, out_path: str) -> None:
    """One process of the (1, n) qwen3-4b prefill: its logits, the
    collectives ``CommDebugMode`` saw and this card's peak bytes; then the
    cell eager and graphed (:func:`graph_on_mesh`)."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.launch.steps import build_cell

    torch.cuda.set_device(rank)
    init_local_group(rank, n, "nccl", path=store)
    mesh = init_device_mesh("cuda", (1, n), mesh_dim_names=("data", "model"))
    cfg = get_config(SERVE_ARCH)
    b, p = SHARDED_PREFILL
    dev = torch.device("cuda", rank)
    cell = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), dev, mesh=mesh)
    args = cell.materialize(0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with comm_debug(args[0]) as comm:
        logits, _ = cell.run_eager(args)
    logits = logits.full_tensor()
    torch.cuda.synchronize(dev)
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)], device=dev)
    peaks = [torch.zeros_like(peak) for _ in range(n)]
    torch.distributed.all_gather(peaks, peak)
    graph = graph_on_mesh(cell, args)
    del cell, args  # and the graph, before the group goes
    gc.collect()
    torch.cuda.synchronize(dev)
    if rank == 0:
        _save_result({"logits": logits.cpu(), "comm": _comm_kinds(comm.get_comm_counts()),
                    "peaks": [int(x) for x in peaks],
                    "graph": {**graph, "eager": {**graph["eager"], "logits": graph["eager"][
                        "logits"].cpu()}, "graphed": {**graph["graphed"], "logits": graph[
                            "graphed"]["logits"].cpu()}}}, out_path)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def sharded_by_layer(cfg, mesh, dev, max_seq: int, seed: int = 0):
    """``cfg``'s model as DTensor parameters on ``mesh`` with each process
    holding only its blocks: built on ``meta``, then each layer's weights
    made whole on the card from ``seed`` + its index (a one-layer model),
    laid out, its blocks copied and the whole freed; the other weights from
    the first layer's build. A model too large for one card is never whole
    on one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import api
    from repro_torch.models.sharding import distribute, rules_for

    rules = rules_for(cfg.family)
    model = api.init_params(cfg, None, "meta", max_seq=max_seq)
    logical = api.param_logical(cfg, model)
    one = dataclasses.replace(cfg, n_layers=1)
    for i in range(cfg.n_layers):
        part = api.init_params(one, seed + i, dev, max_seq=max_seq)
        for name, t in part.named_parameters():
            if name.startswith("layers.0."):
                name = f"layers.{i}." + name[len("layers.0."):]
            elif i:
                continue
            d = distribute(t.data, logical[name], rules, mesh)
            d = DTensor.from_local(d.to_local().clone(), mesh, d.placements, run_check=False,
                                   shape=d.shape, stride=d.stride())
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            mod._parameters[leaf] = torch.nn.Parameter(d, requires_grad=False)
        del part
        torch.cuda.empty_cache()
    return model


def _multi_card_moe_worker(rank: int, n: int, store: str, out_path: str) -> None:
    """One process of the (1, n) MULTI_CARD_MOE prefill: the logits rows of
    the kernel path, the rounding reference and the control against the
    plain path (all on the plain path's routes), the kernel path's with its
    own routes, the collectives ``CommDebugMode`` saw on the kernel path and
    this card's peak bytes."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.launch.steps import build_cell, shard_batch
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.sharding import rules_for, sharded

    torch.cuda.set_device(rank)
    init_local_group(rank, n, "nccl", path=store)
    mesh = init_device_mesh("cuda", (1, n), mesh_dim_names=("data", "model"))
    arch, b, p = MULTI_CARD_MOE
    cfg = get_config(arch)
    dev = torch.device("cuda", rank)
    rules = rules_for(cfg.family)
    t0 = time.perf_counter()
    model = sharded_by_layer(cfg, mesh, dev, p)
    build_s = time.perf_counter() - t0
    batch = shard_batch(cfg, {"tokens": _tokens(cfg, b, p, dev, b * 7919 + p)}, mesh)
    control = dataclasses.replace(PLAIN, attention=_scaled_attention(ZOO_CONTROL, 64),
                                  rmsnorm=_scaled_rmsnorm(ZOO_CONTROL, 64))
    pin = RoutePin(model)

    def prefill(kernels):
        """The prefill's logits, a DTensor (gathered by the caller, outside
        any count of collectives)."""
        with implicit_replication():
            logits, _ = api.prefill(cfg, model, batch, p, sharded(kernels, rules))
        if not bool(torch.isfinite(logits.to_local()).all()):
            raise AssertionError(f"{arch} over {n} cards: logits not finite")
        return logits

    cell = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), dev, mesh=mesh)
    graph = graph_on_mesh(cell, (model, batch))
    del cell  # and its graph, before the peak below
    gc.collect()
    torch.cuda.empty_cache()
    with pin.record():
        plain = prefill(PLAIN).full_tensor()
    rows = {}
    for name, ks in (("rounding", rounding_reference(dev)), ("control", control)):
        with pin.replay():
            rows[name] = _row_rel(prefill(ks).full_tensor(), plain).cpu()
    rows["kernel_own_routes"] = _row_rel(prefill(KERNELS).full_tensor(), plain).cpu()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with comm_debug(model) as comm, pin.replay():
        got = prefill(KERNELS)
    torch.cuda.synchronize(dev)
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)], device=dev)
    rows["kernel"] = _row_rel(got.full_tensor(), plain).cpu()
    peaks = [torch.zeros_like(peak) for _ in range(n)]
    torch.distributed.all_gather(peaks, peak)
    if rank == 0:
        for key in ("eager", "graphed"):
            graph[key]["logits"] = graph[key]["logits"].cpu()
        _save_result({"rows": rows, "comm": _comm_kinds(comm.get_comm_counts()),
                    "graph": graph, "peaks": [int(x) for x in peaks], "build_s": build_s,
                    "held_bytes": sum(t.to_local().numel() * t.element_size()
                                      for t in model.parameters())}, out_path)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def multi_card_moe(n: int, workdir: Path) -> dict:
    """MULTI_CARD_MOE's prefill whole (every layer) on a (1, n) mesh of n
    cards in n processes, the experts split over "model": the kernel path's
    logits rows within twice the rounding reference's largest reading of the
    plain path, the control above that limit in every row (all on the plain
    path's routes, :class:`RoutePin`); the collectives ``CommDebugMode``
    saw, each kind as many as the count on a (1, n) ``fake`` mesh gives,
    all-to-alls among them; each card's peak beside the counted bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import count_mesh
    from repro_torch.launch.steps import build_cell

    arch, b, p = MULTI_CARD_MOE
    cfg = get_config(arch)
    fake = count_mesh((1, n), ("data", "model"))
    _, stats = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), "meta",
                          mesh=fake).count()
    torch.distributed.destroy_process_group()
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res, ended = _run_workers(_multi_card_moe_worker, n, workdir / "store_moe",
                              workdir / "multi_card_moe.pt")
    rows = {k: [float(v.min()), float(v.max())] for k, v in res["rows"].items()}
    limit = 2 * rows["rounding"][1]
    line = {"arch": arch, "layers": cfg.n_layers, "cards": n, "prefill": [b, p],
            "seconds": time.perf_counter() - t0, "workers": ended, "build_s": res["build_s"],
            "rows": rows,
            "limit": limit, "limit_rule": "2 x the rounding reference's largest row",
            "control": f"plain path, RMSNorm and attention x (1 + {ZOO_CONTROL}) past "
                       "position 64 of each block",
            "routes": "every path replays the plain path's routes; kernel_own_routes its own",
            "collectives": res["comm"], "counted_collectives": stats.coll_count_by_kind,
            "counted_collective_bytes": stats.coll_bytes_by_kind,
            "card_peak_bytes": res["peaks"], "counted_peak_bytes": stats.peak_bytes,
            "held_parameter_bytes_card0": res["held_bytes"],
            "counted_argument_bytes": stats.argument_bytes}
    if rows["kernel"][1] > limit:
        raise AssertionError(f"{arch} over {n} cards: kernel path {rows['kernel']} > {limit}")
    if rows["control"][0] <= limit:
        raise AssertionError(f"{arch} over {n} cards: the control passed ({rows['control']} "
                             f"within {limit}): the check does not discriminate")
    if res["comm"] != stats.coll_count_by_kind or not res["comm"].get("all-to-all"):
        raise AssertionError(f"{arch} over {n} cards: CommDebugMode saw {res['comm']}, the "
                             f"count {stats.coll_count_by_kind}")
    line["graphed"] = graphed_line(res["graph"], stats.coll_count_by_kind, limit)
    return line


def multi_card_prefill(cfg, one_card_logits, n: int, workdir: Path) -> dict:
    """qwen3-4b's prefill on a (1, n) mesh of n cards in n processes: its
    logits within SERVE_REL_LIMIT a row of the one-card run's, the
    collectives each kind as many as the count on a (1, n) ``fake`` mesh
    gives, each card's peak beside the counted per-device bytes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import count_mesh
    from repro_torch.launch.steps import build_cell

    b, p = SHARDED_PREFILL
    fake = count_mesh((1, n), ("data", "model"))
    _, stats = build_cell(cfg, ShapeConfig("prefill", p, b, "prefill"), "meta",
                          mesh=fake).count()
    torch.distributed.destroy_process_group()
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res, ended = _run_workers(_multi_card_worker, n, workdir / "store", workdir / "multi_card.pt")
    rel = float(_row_rel(res["logits"], one_card_logits.cpu()).max())
    if rel > SERVE_REL_LIMIT:
        raise AssertionError(f"sharded (1, {n}) prefill: row rel {rel} > {SERVE_REL_LIMIT}")
    if res["comm"] != stats.coll_count_by_kind:
        raise AssertionError(f"sharded (1, {n}) prefill: CommDebugMode saw {res['comm']}, "
                             f"the count {stats.coll_count_by_kind}")
    return {"cards": n, "seconds": time.perf_counter() - t0, "workers": ended, "max_row_rel": rel,
            "collectives": res["comm"], "counted_collective_bytes": stats.coll_bytes_by_kind,
            "card_peak_bytes": res["peaks"], "counted_peak_bytes": stats.peak_bytes,
            "counted_argument_bytes": stats.argument_bytes,
            "graphed": graphed_line(res["graph"], stats.coll_count_by_kind, SERVE_REL_LIMIT)}


def expected_argument_bytes(cfg, shape, mesh_axes) -> int:
    """One device's argument bytes of a sharded cell from the resolver's
    arithmetic alone (each leaf's bytes over the devices that split it):
    the module (and for train the float32 masters, m, v and the step
    counter), the inputs along the batch, the decode cache and position."""
    from repro_torch.models import api
    from repro_torch.models.sharding import logical_to_spec, rules_for, shard_shape

    rules = rules_for(cfg.family)

    def share(shp, logical, itemsize):
        spec = logical_to_spec(logical, rules, mesh_axes, tuple(shp))
        return math.prod(shard_shape(tuple(shp), spec, mesh_axes)) * itemsize

    model = api.init_params(cfg, None, "meta", max_seq=shape.seq_len)
    logical = api.param_logical(cfg, model)
    total = sum(share(p.shape, logical[n], p.element_size()) for n, p in model.named_parameters())
    specs = api.input_specs(cfg, shape)

    def leaves(tree, logical_tree=None):
        if tree is None:
            return 0
        if isinstance(tree, dict):
            return sum(leaves(v, None if logical_tree is None else logical_tree[k])
                       for k, v in tree.items())
        shp, dtype = tree
        item = torch.empty((), dtype=dtype).element_size()
        if not shp:
            return item
        lg = logical_tree if logical_tree is not None else ("batch",) + (None,) * (len(shp) - 1)
        return share(shp, lg, item)

    if shape.kind == "train":
        total += sum(3 * share(p.shape, logical[n], 4) for n, p in model.named_parameters())
        return total + 4 + leaves(specs)
    if shape.kind == "prefill":
        return total + leaves(specs)
    cache = specs.pop("cache")
    return total + leaves(specs) + leaves(cache, api.cache_logical(cfg, shape.global_batch,
                                                                   shape.seq_len))


def split_cpus() -> tuple:
    """(this process's CPUs, the count's): the two halves of its affinity
    (one CPU: the same one for both)."""
    cpus = sorted(os.sched_getaffinity(0))
    half = len(cpus) // 2
    return (cpus[:half] or cpus), (cpus[half:] or cpus)


def host_paced(dev) -> dict:
    """Times a caller sees of host-bound calls at decode size [4, 2560]
    (``cuda_ms``, 200 calls, the median of 5 rounds): the RMSNorm wrapper,
    whose launch path is all host work, and the plain RMSNorm, a chain of
    small PyTorch ops."""
    import statistics

    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    x, w = rms_inputs(RMS_CASES["decode_d2560"], dev)
    calls = {"rmsnorm_wrapper_ms": lambda: rmsnorm_rows_cuda(x, w, 1e-6),
             "rmsnorm_plain_ms": lambda: rmsnorm_plain(x, w, 1e-6)}
    return {k: statistics.median(cuda_ms(fn, 200) for _ in range(5)) for k, fn in calls.items()}


class ShardedDryrun:
    """``python -m repro_torch.launch.dryrun --arch SHARDED_DRYRUN_ARCHS
    --multi-pod both --device cpu`` in a process of its own, pinned to
    ``cpus`` (its count workers follow its affinity), started at once;
    :meth:`result` waits for it and returns its records."""

    def __init__(self, workdir: Path, cpus):
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        self.workdir = workdir
        self.cpus = list(cpus)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.log = open(workdir / "dryrun.log", "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ",".join(SHARDED_DRYRUN_ARCHS), "--multi-pod", "both", "--device", "cpu",
             "--out", str(workdir / "records")], env=env, cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT, start_new_session=True,
            preexec_fn=lambda: os.sched_setaffinity(0, self.cpus))
        self.seconds = None
        self._done = threading.Thread(target=self._wait, daemon=True)
        self._done.start()
        atexit.register(self.stop)

    def stop(self):
        """Ends the process and its count workers (its session) if it runs."""
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def _wait(self):
        self.proc.wait()
        self.seconds = time.perf_counter() - self.t0

    def result(self) -> tuple:
        """(exit code, its wall seconds, the records); the process is killed
        once it has outlived SHARDED_DRYRUN_BUDGET_S."""
        left = SHARDED_DRYRUN_BUDGET_S - (time.perf_counter() - self.t0)
        self._done.join(max(left, 0.0))
        if self.proc.poll() is None:
            self.stop()
            self.log.close()
            raise AssertionError(f"sharded dryrun: not done in {SHARDED_DRYRUN_BUDGET_S} s")
        self._done.join()
        self.log.close()
        recs = [json.loads(p.read_text())
                for p in sorted((self.workdir / "records").glob("*.json"))]
        return self.proc.returncode, self.seconds, recs


def sharded_dryrun(run: ShardedDryrun, one_card: Path) -> dict:
    """The per-device records of SHARDED_DRYRUN_ARCHS (``run``) within
    SHARDED_DRYRUN_BUDGET_S: every record ok or skipped (long_500k of the
    quadratic two), with repro's keys and n_chips 256 / 512; per device the
    argument bytes the resolver's arithmetic gives, times n_chips at least
    the one-card record's; FLOPs times n_chips at least the one-card
    count's; a collective term above 0 (every weight is sharded there)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import production_shape

    rc, seconds, recs = run.result()
    want_n = 2 * len(SHARDED_DRYRUN_ARCHS) * len(SHAPES)
    skipped = [r for r in recs if r["status"] == "skipped"]
    if (rc != 0 or len(recs) != want_n or len(skipped) != SHARDED_SKIPPED
            or any(r["status"] not in ("ok", "skipped") for r in recs)):
        raise AssertionError(f"sharded dryrun: exit {rc}, {len(recs)} records of {want_n}, "
                             f"{len(skipped)} skipped: "
                             f"{[r.get('error') for r in recs if r['status'] == 'error']}")
    table = {}
    for r in recs:
        if r["status"] != "ok":
            continue
        name = f"{r['arch']} {r['shape']} {r['mesh']}"
        missing = [k for k in DRYRUN_KEYS if k not in r]
        shape_, names = production_shape(r["mesh"] == "pod2x16x16")
        n = math.prod(shape_)
        one = json.loads((one_card / f"{r['arch']}_{r['shape']}_1card.json").read_text())
        args_dev = r["memory"]["argument_size_in_bytes"]
        cfg, shape = get_config(r["arch"]), SHAPES[r["shape"]]
        want_args = expected_argument_bytes(cfg, shape, (names, shape_))
        flops = r["cost_analysis"]["flops"]
        if (missing or r["n_chips"] != n or "cards_needed" in r
                or args_dev != want_args
                or args_dev * n < one["memory"]["argument_size_in_bytes"]
                or flops * n < one["cost_analysis"]["flops"]
                or not r["roofline"]["t_collective"] > 0):
            raise AssertionError(f"sharded dryrun {name}: missing {missing}, n_chips "
                                 f"{r['n_chips']}, argument bytes {args_dev} (want "
                                 f"{want_args}; one card {one['memory']}), flops {flops} "
                                 f"(one card {one['cost_analysis']['flops']}), roofline "
                                 f"{r['roofline']}")
        mem = r["memory"]
        table[name] = {"gb": (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9,
                       "flops": flops,
                       "flops_x_chips_over_one_card": flops * n / one["cost_analysis"]["flops"],
                       "collective_gb": r["collective_bytes_total"] / 1e9,
                       "dominant": r["dominant"], "fits": r["fits"],
                       "count_s": r["t_compile_s"]}
    return {"seconds": seconds, "cpus": len(run.cpus), "records": len(recs),
            "skipped": len(skipped), "budget_s": SHARDED_DRYRUN_BUDGET_S, "cells": table}


def sharded_path(dev, workdir: Path, counting: ShardedDryrun) -> dict:
    """The sharded phase (module comment above SHARDED_PREFILL); ``counting``
    is its dry run, started beside the earlier phases (None: a probe
    without it). Returns the launches
    of the sharded main path: every count set to 0 just before it, read
    just after."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    t_phase = time.perf_counter()
    import torch.distributed.tensor  # noqa: F401  (DTensor: the card's torch must have it)
    from torch.testing._internal.distributed import fake_pg  # noqa: F401
    gc.collect()
    torch.cuda.empty_cache()
    counters = serving_launches()
    cfg = get_config(SERVE_ARCH)
    tcfg = get_config(SHARDED_TRAIN[0])
    mcfg = get_config(SHARDED_MOE[0])

    def captures():
        return {**serve_mod.TRACE_COUNT, "train": train_mod.TRACE_COUNT["step"]}

    # each run: the whole cells (the reference; graphs on the card), then on
    # the one-card mesh eager and graphed; the launches of each to match
    runs, mesh, compared = {}, None, 0
    for label, eager in (("whole", False), ("eager", True), ("graphed", False)):
        if label == "eager":
            mesh = make_host_mesh("cuda")
        before = captures()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        serving, serving_ms = sharded_serving(cfg, dev, mesh, eager)
        launches = {k: fn.launches for k, fn in counters.items()}
        train, train_ms = sharded_train(tcfg, dev, mesh, *SHARDED_TRAIN[1:], eager=eager)
        main_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        moe, moe_ms = sharded_prefill(mcfg, dev, mesh, *SHARDED_MOE[1:], eager=eager)
        moe_launches = {k: fn.launches for k, fn in counters.items()}
        out = {"serving": serving, "train": train, "moe_prefill": moe}
        if label == "whole":
            ref = out
        else:  # held to the whole cells' at once: one run's state on the card at a time
            compared += sum(_bitwise(f"{label} {k}", v, ref[k]) for k, v in out.items())
        runs[label] = {"launches": launches, "moe_launches": moe_launches, "main_s": main_s,
                       "ms": {"serving": serving_ms, "train": train_ms, "moe_prefill": moe_ms},
                       "captures": {k: n - before[k] for k, n in captures().items()}}
        del out, serving, train, moe
        gc.collect()
        torch.cuda.empty_cache()
    whole = runs["whole"]
    b, p = SHARDED_PREFILL
    pre, step = step_launches(cfg)
    want = {k: 2 * pre[k] + SHARDED_DECODE_STEPS * step[k] for k in counters}
    for label, r in runs.items():
        if r["launches"] != want or r["moe_launches"] != whole["moe_launches"]:
            raise AssertionError(f"sharded {label}: launches {r['launches']} and MoE prefill "
                                 f"{r['moe_launches']}, step_launches {want}, whole MoE "
                                 f"prefill {whole['moe_launches']}")
    if not all(whole["moe_launches"][k] for k in ("rmsnorm", "flash_attention")):
        raise AssertionError(f"sharded MoE prefill launches {whole['moe_launches']}")
    # one capture per graphed cell and shape; none eager
    one_each = {"prefill": 2, "decode": 1, "train": 1}
    if (runs["eager"]["captures"] != dict.fromkeys(one_each, 0)
            or any(runs[k]["captures"] != one_each for k in ("whole", "graphed"))):
        raise AssertionError(f"sharded captures: { {k: r['captures'] for k, r in runs.items()} }")
    one_card_logits = ref["serving"]["logits"][0]
    graphed = runs["graphed"]
    # the phase's path: the graphed sharded cells, the MoE prefill's among them
    launches = {k: n + graphed["moe_launches"][k] for k, n in graphed["launches"].items()}
    del ref
    # the train CLI on the mesh, as --production-mesh runs it: one capture,
    # the losses bitwise the one-card run's
    arch, n_steps, tb, ts, burst = SHARDED_CLI
    cli = {}
    for label, m in (("whole", None), ("mesh", mesh)):
        ckpt = workdir / f"train_cli_{label}"
        shutil.rmtree(ckpt, ignore_errors=True)
        before, report = train_mod.TRACE_COUNT["step"], {}
        losses = train_mod.train(arch, n_steps, tb, ts, burst, str(ckpt), device="cuda",
                                 mesh=m, report=report, log_every=n_steps)
        shutil.rmtree(ckpt, ignore_errors=True)
        cli[label] = {"losses": losses, "captures": train_mod.TRACE_COUNT["step"] - before,
                      "capture": report["captures"],
                      "step_ms": [t * 1e3 for t in report["step_seconds"]]}
    if cli["mesh"]["losses"] != cli["whole"]["losses"] or any(
            c["captures"] != 1 or len(c["capture"]) != 1 for c in cli.values()):
        raise AssertionError(f"train CLI on the one-card mesh: {cli}")
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "sharded", "torch": torch.__version__, "mesh": [1, 1],
            "backend": "nccl", "prefill": [b, p], "decode_steps": SHARDED_DECODE_STEPS,
            "train": list(SHARDED_TRAIN), "train_steps": SHARDED_TRAIN_STEPS,
            "moe_prefill": list(SHARDED_MOE), "moe_prefill_launches": runs["graphed"][
                "moe_launches"],
            "bitwise_tensors": compared, "bitwise": "graphed = eager = whole",
            "launches": launches, "main_path_s": runs["graphed"]["main_s"],
            "captures": {k: r["captures"] for k, r in runs.items()},
            "host_ms": {k: r["ms"] for k, r in runs.items()},
            "main_s": {k: r["main_s"] for k, r in runs.items()},
            "train_cli": {"arch": arch, "smoke": True, "steps": n_steps, "batch": [tb, ts],
                          **cli}}
    n = torch.cuda.device_count()
    if n >= 2:
        line["multi_card"] = multi_card_prefill(cfg, one_card_logits, n, workdir)
    else:
        line["multi_card"] = "skipped"
    line["cards_visible"] = n
    line["dryrun"] = ("skipped" if counting is None
                      else sharded_dryrun(counting, ROOT / "build" / "dryrun"))
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return launches


# The activation solvers: repro's planner shapes (tests/test_planners.py),
# (batch, seq); offload at OFFLOAD_BUDGET · Q_min, remat at REMAT_BUDGET ·
# Q_min, PIPELINE_STAGES stages; each must raise Infeasible at
# INFEASIBLE_SHARE · Q_min.
PLANNER_SHAPE = (16, 4096)
REMAT_SHAPE = (4, 4096)
OFFLOAD_BUDGET, REMAT_BUDGET, INFEASIBLE_SHARE = 2.0, 64.0, 0.5
PIPELINE_STAGES = 8


def d2d_copy(nbytes: int, reps: int = 5):
    """The least host time of a copy of ``nbytes`` from card 0 to card 1 and
    its synchronize, or None with one card."""
    if torch.cuda.device_count() < 2:
        return None
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda:1")
    best = math.inf
    for _ in range(reps + 1):
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(1)
        best = min(best, time.perf_counter() - t0)
    return best


def planners_path() -> list:
    """``plan_offload``, ``plan_remat`` (with ``segments_for_scan``) and
    ``plan_pipeline`` for every registered architecture at full width on the
    host (numpy DP through the façade, as ``repro`` solves them): each
    plan's host seconds, segments or stages, overhead, recompute fraction
    and balance; every plan within its budget, and offload and remat
    ``Infeasible`` below Q_min. Prints ``h100_pipeline_model``'s constants
    and, with more than one card visible, a measured card-to-card copy."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.core import cost
    from repro_torch.core.offload import min_activation_budget, plan_offload
    from repro_torch.core.partition import Infeasible, within_budget
    from repro_torch.core.pipeline import plan_pipeline
    from repro_torch.core.remat_policy import plan_remat, segments_for_scan

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    def infeasible(fn) -> bool:
        try:
            fn()
        except Infeasible:
            return True
        return False

    rows, bad = [], []
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        b, s = PLANNER_SHAPE
        qmn = min_activation_budget(cfg, b, s)
        off, off_s = timed(lambda: plan_offload(cfg, b, s, OFFLOAD_BUDGET * qmn))
        rb, rs = REMAT_SHAPE
        rq = min_activation_budget(cfg, rb, rs)
        rem, rem_s = timed(lambda: plan_remat(cfg, rb, rs, REMAT_BUDGET * rq))
        pp, pp_s = timed(lambda: plan_pipeline(cfg, b, s, PIPELINE_STAGES))
        n_seg, seg_len = segments_for_scan(cfg.n_layers, rem)
        row = {"arch": arch,
               "offload": {"host_s": off_s, "q_min_bytes": qmn, "segments": off.n_segments,
                           "overhead_fraction": off.overhead_fraction,
                           "within_budget": all(within_budget(x, OFFLOAD_BUDGET * qmn)
                                                for x in off.segment_peak_bytes),
                           "infeasible_below_q_min": infeasible(
                               lambda: plan_offload(cfg, b, s, INFEASIBLE_SHARE * qmn))},
               "remat": {"host_s": rem_s, "q_min_bytes": rq, "segments": rem.n_segments,
                         "recompute_fraction": rem.recompute_fraction,
                         "saved_bytes": rem.saved_bytes,
                         "segments_for_scan": [n_seg, seg_len],
                         "infeasible_below_q_min": infeasible(
                             lambda: plan_remat(cfg, rb, rs, INFEASIBLE_SHARE * rq))},
               "pipeline": {"host_s": pp_s, "stages": pp.n_stages, "balance": pp.balance,
                            "bottleneck_s": pp.bottleneck_seconds,
                            "max_stage_weight_bytes": max(pp.stage_weight_bytes)}}
        rows.append(row)
        if not (row["offload"]["within_budget"] and row["offload"]["infeasible_below_q_min"]
                and row["remat"]["infeasible_below_q_min"] and n_seg * seg_len == cfg.n_layers
                and pp.n_stages == len(pp.bounds) == PIPELINE_STAGES):
            bad.append(arch)
    pm = cost.h100_pipeline_model()
    copy_64mb, copy_4kb = d2d_copy(64 << 20), d2d_copy(4096)
    emit({"phase": "planners", "shape": list(PLANNER_SHAPE), "remat_shape": list(REMAT_SHAPE),
          "budgets": {"offload": OFFLOAD_BUDGET, "remat": REMAT_BUDGET,
                      "infeasible": INFEASIBLE_SHARE},
          "archs": rows, "host_s": sum(r[k]["host_s"] for r in rows
                                       for k in ("offload", "remat", "pipeline")),
          "h100_pipeline_model": {"hop_init_s": pm.read.c0, "bytes_per_s": 1.0 / pm.read.c1,
                                  "source": "NVLink 4 data sheet, one way; hop start-up "
                                            "LAUNCH_S"},
          "cards_visible": torch.cuda.device_count(),
          "measured_d2d_copy_s": None if copy_64mb is None else
              {"64MB": copy_64mb, "4KB": copy_4kb, "64MB_bytes_per_s": (64 << 20) / copy_64mb}})
    if len(rows) != 10 or bad:
        raise AssertionError(f"planner checks failed for {bad}")
    return rows


def multi_card_main() -> int:
    """``python3 chip_smoke.py --multi-card``: the sharded phase's (1, n)
    qwen3-4b prefill alone on every visible card (two or more), against the
    one-card prefill on card 0; prints its line."""
    if torch.cuda.device_count() < 2:
        print("chip_smoke --multi-card: needs two CUDA cards or more", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import load_library

    load_library()
    dev = torch.device("cuda", 0)
    cfg = get_config(SERVE_ARCH)
    one = sharded_serving(cfg, dev, None)[0]["logits"][0]
    gc.collect()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    line = multi_card_prefill(cfg, one, n, ROOT / "build" / "sharded")
    emit({"phase": "sharded_multi_card", "torch": torch.__version__, **line})
    del one
    gc.collect()
    torch.cuda.empty_cache()
    moe = multi_card_moe(n, ROOT / "build" / "sharded")
    print(nvidia_smi(), flush=True)
    emit({"phase": "sharded_multi_card_moe", "torch": torch.__version__, **moe})
    return 0


def main() -> int:
    if "--multi-card" in sys.argv[1:]:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; needs CUDA cards",
                  file=sys.stderr)
            return 2
        return multi_card_main()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.core.apps import headcount as hc
    from repro_torch.core.cost import CostModel, LinearTransfer
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.partition_torch import sweep, sweep_from_columns
    from repro_torch.core.runtime import execute_atomic
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.conv_window.kernel import (conv_window_frame_cuda,
                                                        conv_window_scores_cuda)
    from repro_torch.kernels.conv_window.ref import conv_window_scores_plain
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.kernels.partition_sweep.ops import budget_lanes, device_slots
    from repro_torch.kernels.partition_sweep.ref import sweep_columns_plain
    from repro_torch.launch import headcount as launch

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    card = nvidia_smi()

    # -- phase 1: card and build ----------------------------------------------
    t0 = time.perf_counter()
    lib = load_library()
    sass = tensor_core_sass(lib._name)
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "build_s": time.perf_counter() - t0,
          "flash_tensor_core_sass": sass["flash"], "mlstm_tensor_core_sass": sass["mlstm"]})

    # the sharded phase's dry run counts on the host beside the card phases,
    # on its own half of the CPUs; this process keeps the other half
    main_cpus, count_cpus = split_cpus()
    os.sched_setaffinity(0, main_cpus)
    torch.set_num_threads(len(main_cpus))
    host_alone = host_paced(dev)
    counting = ShardedDryrun(ROOT / "build" / "sharded_dryrun", count_cpus)

    # -- phase 1b: the host-offload cost model's constants on this card -------
    t0 = time.perf_counter()
    consts = cost_constants(dev, lib, card)
    consts["seconds"] = time.perf_counter() - t0
    measured = [v for k, v in consts.items() if k.endswith("_measured")]
    if not all(np.isfinite(v) and v > 0 for v in measured):
        raise AssertionError(f"cost constants not measured: {consts}")
    emit({"phase": "cost_constants", **consts})

    sweep_err = {"max_abs_err": 0.0, "bests_mismatches": 0, "comparisons": 0}

    def sweep_pair(csr, cost, mode, dev_plain):
        """Kernel vs plain version on one export; adds the measured max |Δ|
        over ``mns`` and the count of differing ``bests`` to ``sweep_err``,
        then raises unless the tables are bitwise equal."""
        _, objective, qv, k, kobj = mode
        budget, exact_k, cmax = budget_lanes(qv, objective, k, kobj)
        a_dev = device_slots(csr, cost, dev)
        a_pl = device_slots(csr, cost, dev_plain)
        got = sweep_columns_cuda(*a_dev, torch.as_tensor(budget).to(dev),
                                 exact_k=exact_k, combine_max=cmax)
        want = sweep_columns_plain(*a_pl, torch.as_tensor(budget).to(dev_plain),
                                   exact_k=exact_k, combine_max=cmax)
        torch.cuda.synchronize()
        g_mns, g_bests = (t.cpu() for t in got)
        w_mns, w_bests = (t.cpu() for t in want)
        both_inf = torch.isinf(g_mns) & torch.isinf(w_mns) & (g_mns == w_mns)
        diff = torch.where(both_inf, torch.zeros_like(g_mns), (g_mns - w_mns).abs())
        err = float(diff.max().item()) if diff.numel() else 0.0
        mismatches = int((g_bests != w_bests).sum().item())
        sweep_err["max_abs_err"] = max(sweep_err["max_abs_err"], err)
        sweep_err["bests_mismatches"] += mismatches
        sweep_err["comparisons"] += 1
        if not (torch.equal(g_mns, w_mns) and torch.equal(g_bests, w_bests)):
            raise AssertionError(f"sweep kernel != plain version ({mode[0]}): "
                                 f"max |Δ| {err}, {mismatches} bests differ")
        return got

    # -- phase 2: sweep kernel vs its plain version on the card ----------------
    cm = hc.paper_cost_model()
    rng = random.Random(0)
    cases = [("visual-reduced", hc.build_graph(hc.VISUAL.reduced(16)), cm)]
    for s in range(4):
        cases.append((f"random{s}", random_graph(rng, GraphBuilder, 40, False),
                      CostModel(rng.uniform(0, 1), LinearTransfer(rng.uniform(0, 0.1), 1e-4),
                                LinearTransfer(rng.uniform(0, 0.1), 2e-4))))
    cases.append(("dyadic-tie", random_graph(rng, GraphBuilder, 30, True),
                  CostModel(0.25, LinearTransfer(0.25, 2.0 ** -10),
                            LinearTransfer(0.0, 2.0 ** -12))))
    n_checked = 0
    for name, g, cost in cases:
        e_app = g.total_task_cost()
        grid = (None, 0.0, 0.3 * e_app, 0.6 * e_app, 1.1 * e_app)
        for mode in sweep_modes(grid, max(1, g.n_tasks // 3)):
            sweep_pair(g.to_csr_arrays(), cost, mode, dev)
            n_checked += 1
    emit({"phase": "sweep_vs_plain_on_card", "graphs": [c[0] for c in cases],
          "comparisons": n_checked, "parity": "bitwise"})

    # -- phase 2b: the edges of the sweep's cluster layout ---------------------
    # Each case must reach the edge it names; every table bitwise.
    from repro_torch.kernels._build import smem_optin
    from repro_torch.kernels.partition_sweep.kernel import sweep_layout

    limit = smem_optin(0)
    erng = random.Random(17)
    one = GraphBuilder()
    one.packet("x", 64, external=True)
    one.task("t0", reads=["x"], writes=[], cost=1.5)
    spread45 = spread_graph(erng, GraphBuilder, 45)
    spread1001 = spread_graph(erng, GraphBuilder, 1001)
    ecost = CostModel(0.3, LinearTransfer(0.02, 1e-4), LinearTransfer(0.05, 2e-4))
    thermal = hc.build_graph(hc.THERMAL)
    t_grid = tuple(float(q) for q in np.geomspace(0.132, thermal.total_task_cost() * 1.05, 96))
    edges = [  # (case, graph, cost, modes, what the layout must show)
        ("n1_below_cluster", one.build(), ecost, None, "n < cluster"),
        ("n3_below_cluster", spread_graph(erng, GraphBuilder, 3), ecost, None, "n < cluster"),
        ("n45_not_multiple_of_slice", spread45, ecost, None, "n % slice, crossings"),
        ("n1001_not_multiple_of_slice", spread1001, ecost, None, "n % slice, crossings"),
        ("exact_k_41_lanes_n45", spread45, ecost,
         [("exact_k_sum", "exact_k", (0.5 * spread45.total_task_cost(),), 40, "sum"),
          ("exact_k_max", "exact_k", (0.5 * spread45.total_task_cost(),), 40, "max")],
         "lanes > warps, crossings"),
        ("thermal_96_lane_grid", thermal, cm, [("sum", "sum", t_grid, None, "sum")],
         "dp in device memory"),
    ]
    edge_rows = []
    for name, g, cost, modes, edge in edges:
        csr = g.to_csr_arrays()
        if modes is None:
            e_app = g.total_task_cost()
            modes = sweep_modes((None, 0.0, 0.3 * e_app, 0.6 * e_app, 1.1 * e_app),
                                max(1, g.n_tasks // 3))
        for mode in modes:
            budget, _, _ = budget_lanes(mode[2], mode[1], mode[3], mode[4])
            lay = sweep_layout(g.n_tasks, len(budget), limit)
            crossings = slice_crossings(csr, lay)
            reached = {"n < cluster": g.n_tasks < lay.cluster,
                       "n % slice, crossings": (g.n_tasks % lay.slice != 0
                                                and min(crossings) > 0),
                       "lanes > warps, crossings": len(budget) > 32 and min(crossings) > 0,
                       "dp in device memory": not lay.dp_in_smem}[edge]
            if not reached:
                raise AssertionError(f"sweep case {name} misses its edge ({edge}): {lay}, "
                                     f"crossings {crossings}")
            sweep_pair(csr, cost, mode, dev)
            edge_rows.append({"case": name, "mode": mode[0], "n": g.n_tasks, "nq": len(budget),
                              "cluster": lay.cluster, "slice": lay.slice,
                              "dp_in_smem": lay.dp_in_smem,
                              "load_and_free_crossings": list(crossings)})
    emit({"phase": "sweep_cluster_edges_vs_plain_on_card", "cases": edge_rows,
          "parity": "bitwise"})

    # -- phase 3: full head count, kernel on the card vs plain on the CPU ------
    full = {}
    for spec in (hc.THERMAL, hc.VISUAL):
        g = hc.build_graph(spec)
        csr = g.to_csr_arrays()
        mm, _ = sweep_pair(csr, cm, ("minimax", "minimax", (), None, "sum"), cpu)
        qmn = float(mm[g.n_tasks - 1, 0])
        e_app = g.total_task_cost()
        grid = tuple([qmn] + [float(q) for q in np.geomspace(qmn * 1.01, e_app * 1.05, 7)]
                     + [None])
        s_mns, s_bests = sweep_pair(csr, cm, ("sum", "sum", grid, None, "sum"), cpu)
        res = sweep_from_columns(g.n_tasks, grid, s_mns.cpu().numpy(), s_bests.cpu().numpy())
        k = len(res.bounds(0))
        k_mns, _ = sweep_pair(csr, cm, ("exact_k", "exact_k", (qmn,), k, "sum"), cpu)
        full[spec.name] = (g, csr, qmn, grid)
        out = {"spec": spec.name, "tasks": g.n_tasks, "q_min": qmn,
               "e_total_at_q_min": float(s_mns[g.n_tasks - 1, 0].item()),
               "bursts_at_q_min": k,
               "exact_k_at_q_min_feasible": bool(torch.isfinite(k_mns[g.n_tasks - 1, k]).item())}
        if spec.name == "thermal":
            out["bursts_at_132mJ"] = len(sweep(g, cm, [0.132], device=dev).bounds(0))
            if (abs(qmn - THERMAL_Q_MIN) > 1e-9 or k != 18
                    or out["bursts_at_132mJ"] != 18 or not out["exact_k_at_q_min_feasible"]):
                raise AssertionError(f"THERMAL head count off the paper: {out}")
        elif not out["exact_k_at_q_min_feasible"]:
            raise AssertionError(f"exact-K at Q_min infeasible: {out}")
        emit({"phase": "full_headcount_kernel_vs_plain_cpu", "parity": "bitwise", **out})

    # -- phase 4: CNN kernels vs their plain versions on the card -------------
    # The batch kernel (repro's contract) at each N of CONV_BATCHES; the frame
    # kernel (one launch per CNN task) at every THERMAL window of a seeded
    # random normalized frame, against a control that must exceed the
    # tolerance: the plain path one column over.
    w = hc.weights_to_torch(hc.cnn_weights(0), dev)
    wl = [w[k].contiguous() for k in ("conv1", "b1", "conv2", "b2", "fc", "fc_b")]
    conv_err = {}
    windows = {}
    for n in CONV_BATCHES:
        x = torch.from_numpy(np.random.RandomState(n).rand(n, 12, 12).astype(np.float32)).to(dev)
        windows[n] = x
        got = conv_window_scores_cuda(x, *wl)
        want = conv_window_scores_plain(x, *wl)
        torch.cuda.synchronize()
        err = (got - want).abs()
        lim = CONV_TOL * torch.clamp(want.abs(), min=1.0)
        if not bool(torch.isfinite(got).all()) or bool((err > lim).any()):
            raise AssertionError(f"conv kernel off its plain version at N={n}: "
                                 f"max |Δ| {err.max().item()}")
        conv_err[n] = err.max().item()
    frame = conv_frame_check(dev, hc)
    emit({"phase": "conv_vs_plain_on_card", "batch_max_abs_err": conv_err,
          **{k: v for k, v in frame.items() if not k.startswith("_")},
          "tolerance": f"{CONV_TOL}*max(1,|score|)"})

    # -- host-bound call times beside the count, against those without it ----
    emit({"phase": "host_paced", "main_cpus": len(main_cpus), "count_cpus": len(count_cpus),
          "count_running": counting.proc.poll() is None, "without_count": host_alone,
          "beside_count": host_paced(dev)})

    # -- phase 5: the main path ------------------------------------------------
    sweep_columns_cuda.launches = 0
    conv_window_frame_cuda.launches = 0
    t0 = time.perf_counter()
    r = launch.run("thermal", device=dev, emit=emit)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"partition_sweep": sweep_columns_cuda.launches,
                "conv_window_frame": conv_window_frame_cuda.launches}
    # One frame launch per CNN task run: every task atomically, every task
    # under the runtime, and the CNN tasks of the burst its power failure
    # replays (launch.run injects it at burst n_bursts // 2).
    part = r["partition"]
    g_thermal = full["thermal"][0]
    i, j = part.bounds[part.n_bursts // 2]
    n_cnn = sum(hc.THERMAL.n_cnn)
    replayed = sum(g_thermal.task(k).name.startswith("cnn") for k in range(i, j + 1))
    want_frame = 2 * n_cnn + replayed
    g_cpu = hc.build_graph(hc.THERMAL, with_fns=True, seed=launch.SEED, device=cpu)
    head_cpu = int(execute_atomic(g_cpu, {}, device=cpu)["headcount"])
    ok = (r["headcount"] == r["headcount_atomic"] == head_cpu
          and r["power_failures"] == 1 and r["q_min"] == full["thermal"][2]
          and r["partition"].n_bursts == 18 and launches["conv_window_frame"] == want_frame)
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
          "conv_window_frame_expected": want_frame, "cnn_tasks_replayed": replayed,
          "headcount_runtime": r["headcount"], "headcount_atomic_card": r["headcount_atomic"],
          "headcount_cpu": head_cpu, "ok": ok})
    if not ok or min(launches.values()) < 1:
        raise AssertionError("main path check failed")

    # -- phase 6: device trace of the execution half ---------------------------
    # Atomic execution of the same graph on the card: host-clock time of an
    # untraced run, then the card's busy time from a traced one. The
    # profiler's own bookkeeping slows the traced run many times over, so
    # the idle share is taken against the untraced run.
    g_exec = hc.build_graph(hc.THERMAL, with_fns=True, seed=launch.SEED, device=dev)
    execute_atomic(g_exec, {}, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    execute_atomic(g_exec, {}, device=dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    rows = profile_device(lambda: execute_atomic(g_exec, {}, device=dev))
    busy_s = sum(t for t, _ in rows.values()) / 1e6
    conv_rows = [(t, c) for k, (t, c) in rows.items() if "conv_window_frame_kernel" in k]
    conv_launches = sum(c for _, c in conv_rows)
    # Device ops launched at least once per CNN task, besides the CNN kernel
    # (rows without device time are the runtime API's host calls).
    per_task = sorted(k[:80] for k, (t, c) in rows.items()
                      if t > 0 and c >= n_cnn and "conv_window_frame_kernel" not in k)
    seen = busy_s > 0  # else the profiler saw no device activity: not measured
    emit({"phase": "execution_trace", "what": "execute_atomic, full THERMAL",
          "host_s": host_s, "device_busy_s": busy_s if seen else None,
          "idle_share": 1.0 - busy_s / host_s if seen else None,
          "cnn_tasks": n_cnn, "conv_kernel_s": sum(t for t, _ in conv_rows) / 1e6,
          "conv_kernel_launches": conv_launches,
          "conv_kernel_us_per_launch": (sum(t for t, _ in conv_rows) / conv_launches
                                        if conv_launches else None),
          "device_launches_per_cnn_task": (conv_launches + sum(
              c for k, (_, c) in rows.items() if k[:80] in per_task)) / n_cnn,
          "other_ops_per_cnn_task": per_task, "device_ops": len(rows),
          "device_launches": sum(c for t, c in rows.values() if t > 0),
          "top_device_ops": sorted(([k[:80], t / 1e6, c] for k, (t, c) in rows.items()),
                                   key=lambda x: -x[1])[:6]})
    if conv_launches != n_cnn or per_task:
        raise AssertionError(f"execution trace: {conv_launches} CNN kernel launches for "
                             f"{n_cnn} CNN tasks; other ops once per task: {per_task}")

    # -- phase 6b: the runtime traced, with one power failure ------------------
    # One frame launch per CNN task run: every task once, and the CNN tasks
    # of the burst the power failure replays.
    conv_window_frame_cuda.launches = 0
    trace_row = runtime_trace(g_exec, part, dev, r["headcount_atomic"])
    trace_row["conv_window_frame_launches"] = conv_window_frame_cuda.launches
    trace_row["conv_window_frame_expected"] = n_cnn + replayed
    emit({"phase": "runtime_trace", "what": "Q_min partition, full THERMAL", **trace_row})
    if trace_row["conv_window_frame_launches"] != n_cnn + replayed:
        raise AssertionError(f"runtime trace: CNN launches {trace_row}")

    # -- phase 6c: plan tables of qwen3-4b and xlstm-1.3b on the sweep kernel --
    cache_dir = ROOT / "build" / "plan_table_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    sweep_columns_cuda.launches = 0
    t0 = time.perf_counter()
    built = plan_table_path(cache_dir)
    plan_s = time.perf_counter() - t0
    plan_launches = sweep_columns_cuda.launches
    t0 = time.perf_counter()
    plan_rows = plan_table_checks(built)
    emit({"phase": "plan_table", "seconds": plan_s, "checks_s": time.perf_counter() - t0,
          "sweep_launches": plan_launches, "tables": plan_rows})
    if plan_launches < 1:
        raise AssertionError("the plan-table path launched no sweep kernel")

    # -- phases 7-11: the serving kernels, the serving path, every flash cell,
    # parity, trace ------------------------------------------------------------
    from repro_torch.configs import get_config

    rms_err, flash_err = model_kernel_checks(dev)
    cfg = get_config(SERVE_ARCH)
    params, serve_launches = serve_path(dev, cfg, SERVE_REQUESTS, *qwen_expected(cfg))
    flash_cells(cfg, params, dev, SERVE_REQUESTS)
    serve_parity(cfg, params, dev)
    serve_prefill_graphs(cfg, params, dev, SERVE_REQUESTS, serve_trace(cfg, params, dev))
    serve_step_graphs(cfg, params, dev, SERVE_REQUESTS[0])
    time_tables = {t["arch"]: t["table"] for t in built if t["kind"] == "time"}
    launches_by_path = {SERVE_ARCH: serve_launches}
    launches_by_path[f"{SERVE_ARCH} planned"] = serve_planned(
        cfg, params, dev, time_tables[SERVE_ARCH], *PLANNED[SERVE_ARCH])
    launches_by_path[f"{SERVE_ARCH} traffic"], traffic = traffic_path(
        cfg, params, dev, time_tables[SERVE_ARCH])

    # -- the calibration loop on the traffic run's ledger, and the dense engine
    calibration_launches = calibration_loop(cfg, built, traffic.ledger, dev)
    dense_engine(built, full["thermal"][0], cm)
    del params
    torch.cuda.empty_cache()

    # -- swarm placement and the dse CLI ---------------------------------------
    swarm = placement_path(ROOT / "build" / "swarm", dev)
    dse_launches = dse_path(built, traffic.ledger, swarm, (thermal, cm, t_grid),
                            ROOT / "build" / "dse", dev)
    del traffic

    # -- phases 12-17: the xLSTM path: mLSTM kernel, serving, checks, trace ---
    mlstm_err = mlstm_kernel_checks(dev)
    xcfg = get_config(XLSTM_ARCH)
    xparams, xlstm_launches = serve_path(dev, xcfg, XLSTM_REQUESTS, *xlstm_expected(xcfg))
    xlstm_layer_checks(xcfg, xparams, dev)
    xlstm_f32_parity(xcfg, xparams, dev)
    xlstm_bf16_parity(xcfg, xparams, dev)
    serve_prefill_graphs(xcfg, xparams, dev, XLSTM_REQUESTS,
                         serve_trace(xcfg, xparams, dev, XLSTM_REQUESTS[0]))
    serve_step_graphs(xcfg, xparams, dev, XLSTM_REQUESTS[0])
    launches_by_path[XLSTM_ARCH] = xlstm_launches
    launches_by_path[f"{XLSTM_ARCH} planned"] = serve_planned(
        xcfg, xparams, dev, time_tables[XLSTM_ARCH], *PLANNED[XLSTM_ARCH])
    del xparams
    torch.cuda.empty_cache()

    # -- the model zoo: eight architectures served at full width ---------------
    zoo_launches, zoo_sweeps = zoo_path(dev, ROOT / "build" / "zoo")
    launches_by_path.update(zoo_launches)

    # -- training: every family on the card, tinyllama-1.1b at full width -----
    train_launches, train_sweeps = train_path(dev, ROOT / "build" / "train")
    launches_by_path.update(train_launches)

    # -- the activation solvers over the ten architectures ---------------------
    planners_path()

    # -- the dry run: every (arch × shape) cell counted, the cells that fit run
    launches_by_path["dryrun"] = dryrun_path(dev, ROOT / "build" / "dryrun")

    # -- the sharded cells: bitwise the unsharded ones on one card, the
    # (1, n) prefill with more cards, the dry run per device of the pod meshes
    launches_by_path["sharded"] = sharded_path(dev, ROOT / "build" / "sharded", counting)

    # -- phase 18: times and bounds at the main paths' shapes ------------------
    # ``ms`` is the kernel's device time per launch; ``wrapper_ms`` and
    # ``plain_ms`` are per call as a caller sees them, host work included.
    g, csr, qmn, grid = full["thermal"]
    modes = [("minimax", (), None, "sum"), ("sum", grid, None, "sum"),
             ("exact_k", (qmn,), r["exact_k"].n_bursts, "sum")]
    totals = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_time = {"bytes": 0.0, "operations": 0.0}
    ms_from = set()
    by_mode = {}
    ops_col = _column_ops(csr)
    for objective, qv, k, kobj in modes:
        budget, exact_k, cmax = budget_lanes(qv, objective, k, kobj)
        a = device_slots(csr, cm, dev)
        b = torch.as_tensor(budget).to(dev)
        fn = lambda: sweep_columns_cuda(*a, b, exact_k=exact_k, combine_max=cmax)  # noqa: E731
        ms, how, seen = kernel_ms(fn, 3, "sweep_kernel")
        ms_from.add(how)
        wms = cuda_ms(fn, 3)
        pms = cuda_ms(lambda: sweep_columns_plain(*a, b, exact_k=exact_k, combine_max=cmax), 1)
        nq, n = len(budget), csr.n_tasks
        nbytes = (4 * (n + 1) + 16 * n + 28 * csr.nnz_reads + 8 * nq + 12 * n * nq)
        ops = ops_col + 3 * nq * n * (n + 1) // 2
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F64_PER_S
        by = "operations" if t_ops >= t_bytes else "bytes"
        bound = max(t_bytes, t_ops) * 1e3
        lay = sweep_layout(n, nq, limit)
        by_mode[objective] = {"nq": nq, "ms": ms, "us_per_column": ms * 1e3 / n,
                              "profiled_launches": seen, "wrapper_ms": wms, "plain_ms": pms,
                              "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops,
                              "layout": {"cluster": lay.cluster, "slice": lay.slice,
                                         "dp_in_smem": lay.dp_in_smem}}
        for key, v in (("ms", ms), ("wrapper_ms", wms), ("plain_ms", pms), ("bound_ms", bound)):
            totals[key] += v
        bound_time[by] += bound
    sweep_entry = {
        "name": "partition_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/partition_sweep/csrc/partition_sweep.cu",
        "replaces": "src/repro/kernels/partition_sweep/kernel.py:78",
        "launches": (launches["partition_sweep"] + plan_launches + calibration_launches
                     + swarm["launches"] + dse_launches + sum(zoo_sweeps.values())
                     + train_sweeps),
        "launches_by_path": {"headcount": launches["partition_sweep"],
                             "plan_table": plan_launches,
                             "calibration": calibration_launches,
                             "placement": swarm["launches"], "dse": dse_launches,
                             **zoo_sweeps, "train": train_sweeps},
        "max_abs_err": sweep_err["max_abs_err"],
        "bests_mismatches": sweep_err["bests_mismatches"],
        "compared_tables": sweep_err["comparisons"],
        **totals, "ms_from": sorted(ms_from),
        "us_per_column": {m: v["us_per_column"] for m, v in by_mode.items()},
        "bound_by": max(bound_time, key=bound_time.get), "library_ms": None,
        "library_note": "no single PyTorch call computes the fused sweep + DP",
        "shape": "THERMAL N=5458, nnz=10908; minimax + 9-lane sum + exact-K K=18, summed",
        "by_mode": by_mode,
    }
    conv_entry = conv_window_entry(dev, lib, launches["conv_window_frame"], frame, windows,
                                   wl, conv_err)
    kernels = [sweep_entry, conv_entry, rmsnorm_entry(dev, launches_by_path, rms_err),
               flash_entry(dev, launches_by_path, flash_err),
               mlstm_entry(dev, launches_by_path, mlstm_err)]
    print(card, flush=True)
    emit({"kernels": kernels, "card": card})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _column_ops(csr) -> int:
    """Floating-point operations of the live-column updates that this
    export's data needs: extensions, loads, freed stores, diagonals."""
    n = csr.n_tasks
    ptr = csr.read_ptr.astype(np.int64)
    task = np.repeat(np.arange(1, n + 1), np.diff(ptr))        # j of each slot
    loads = np.maximum(task - 1 - csr.read_lt, 0).sum()
    freed = np.where((csr.read_linf == task) & (csr.read_writer >= 1),
                     csr.read_writer, 0).sum()
    return int(n * (n - 1) // 2 + loads + freed + csr.nnz_reads + 3 * n)


if __name__ == "__main__":
    sys.exit(main())
