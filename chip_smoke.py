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
5. each decode step of both models is one CUDA graph replay (one capture
   per request shape, counted by ``TRACE_COUNT``; a replay adds the kernel
   launches its graph holds), held against the eager masked decode on the
   same request (each step's logits, the tokens, no capture on a second
   request), with decode ms/token and one step's idle share of each path;
6. planned serving (``serve(plan_table=...)``) at full width on the time
   tables the plan_table phase built: qwen3-4b b4 × p512 × g16 in 4 energy
   cycles with one power failure, xlstm-1.3b b1 × p512 × g8 in 3 cycles,
   each equal to unplanned serving in tokens, with one commit per cycle,
   no build, capture or solve on the request path, and the NVM's bytes and
   copy times;
7. the traffic harness over qwen3-4b's planned executor at full width
   (3 arrivals of b1 × p128 × g8 against a harvest pool that defers one),
   tokens equal to unplanned serving, requests/s and latency percentiles.

Each phase prints one JSON line; the kernels line carries launches, times
and bounds measured in this run; the last line is the device summary. Any
mismatch raises, so the exit code is nonzero. Without a card, or without
the rest of the repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import random
import shutil
import subprocess
import sys
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
    "noncausal_sk_ne_sq": (2, 100, 300, 8, 2, 128, False, torch.bfloat16),
    "f32_serve_b4_s512": (4, 512, 512, 32, 8, 128, True, torch.float32),
    "f32_serve_b1_s1000": (1, 1000, 1000, 32, 8, 128, True, torch.float32),
    "f32_hd64_tail": (1, 200, 200, 8, 2, 64, True, torch.float32),
    "f32_hd128_noncausal": (1, 40, 72, 4, 4, 128, False, torch.float32),
}


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
    emit({"phase": "serving_kernels_vs_plain_on_card", "rmsnorm_max_abs_err": rms_err,
          "flash_max_abs_err": flash_err, "share_of_bound_used": bound_used,
          "tolerance": "repro's |Δ| ≤ tol·(1+|plain|) (rmsnorm 1e-2; flash 0.05 bf16, "
                       "2e-5 f32) and the rounding bounds: rmsnorm (d+32)·2^-23·|plain| "
                       "[+ (2^-7 + 2^-14)·|plain| in bf16] + 1e-6; bf16 flash "
                       "2^-7·(|plain| + A) + 1e-6, A = plain on |v|"})
    return rms_err, flash_err


def serve_path(dev, cfg, requests, want_params, want_launches):
    """A serving main path: build ``cfg``'s model at full width, serve
    ``requests`` (batch, prompt, generated tokens) through the kernels and
    the graphed decode, count the launches (a replay adds the launches its
    graph holds) and the decode captures (one per request shape).
    ``want_params``: (param_count(), the parameter tensors' numel);
    ``want_launches``: {kernel: launches over all the requests}."""
    from repro_torch.launch.serve import TRACE_COUNT, serve
    from repro_torch.models import api

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
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
    captures0 = TRACE_COUNT["decode"]
    served = []
    t0 = time.perf_counter()
    for b, p, g in requests:
        report = {}
        seqs = serve(cfg.name, b, p, g, seed=0, device=dev, params=params, report=report)
        served.append({"batch": b, "prompt": p, "gen": g, **report,
                       "tokens_ok": bool(seqs.shape == (b, g) and seqs.min() >= 0
                                         and seqs.max() < cfg.vocab)})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    captures = TRACE_COUNT["decode"] - captures0
    shapes = len({(b, p + g) for b, p, g in requests})
    ok = (launches == want_launches and all(r["tokens_ok"] for r in served)
          and captures == shapes)
    emit({"phase": "serve_path", "arch": cfg.name, "seconds": seconds, "requests": served,
          "launches": launches, "expected_launches": want_launches,
          "decode_captures": captures, "request_shapes": shapes,
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
    def attention(q, k, v, causal):
        from repro_torch.models.common import PLAIN

        o = PLAIN.attention(q, k, v, causal)
        scale = torch.ones(q.shape[1], device=q.device, dtype=torch.float32)
        scale[first:] += excess
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


def qwen_flash_cells(cfg, params, dev):
    """Every flash cell of both qwen3-4b prefills at full width: q, k and v
    of all 36 layers captured on the plain path, then the kernel against its
    plain version on each, held to repro's 0.05 and to
    :func:`flash_bound`. A control, the plain output × (1 + 2^-5) past
    position 64 (rounded to bfloat16), must exceed the bound in every
    cell."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ops import to_bkv
    from repro_torch.kernels.flash_attention.ref import attention_plain, flash_bound
    from repro_torch.models import api
    from repro_torch.models.common import PLAIN

    out = []
    for b, p, g in SERVE_REQUESTS:
        captured = []

        def capture(q, k, v, causal):
            captured.append((q, k, v, causal))
            return PLAIN.attention(q, k, v, causal)

        api.prefill(cfg, params, {"tokens": _tokens(cfg, b, p, dev, 23 + b)}, p + g,
                    dataclasses.replace(PLAIN, attention=capture))
        shares, faults = [], []
        while captured:
            q, k, v, causal = captured.pop(0)
            qg, kg, vg = to_bkv(q, k, v)
            got = flash_attention_bkv_cuda(qg, kg, vg, causal=causal)
            torch.cuda.synchronize()
            want = attention_plain(qg, kg, vg, causal=causal)
            _held(got, want, FLASH_TOL[torch.bfloat16] * (1 + want.float().abs()))
            bound = flash_bound(qg, kg, vg, want, causal)
            shares.append(_held(got, want, bound)[1])
            bad = want.to(torch.float32)
            bad[:, 64:] *= 1.0 + FLASH_FAULT
            bad = bad.to(want.dtype).to(torch.float32)
            faults.append(float(((bad - want.to(torch.float32)).abs() / bound)[:, 64:].max()))
            del q, k, v, qg, kg, vg, got, want, bound, bad
        out.append({"batch": b, "prompt": p, "cells": len(shares),
                    "largest_share_of_bound": max(shares), "share_by_cell": shares,
                    "control_smallest_share": min(faults), "control_share_by_cell": faults})
    emit({"phase": "qwen_flash_cells_vs_plain", "requests": out,
          "cells": sum(r["cells"] for r in out),
          "bound": "bf16 flash 2^-7·(|plain| + A) + 1e-6, A = plain on |v|; and repro's "
                   "0.05·(1 + |plain|)",
          "control": "plain o x (1 + 2^-5) past position 64 must use more than the whole "
                     "bound in every cell"})
    if [r["cells"] for r in out] != [cfg.n_layers] * len(SERVE_REQUESTS):
        raise AssertionError(f"captured {[r['cells'] for r in out]} flash cells")
    blind = [r["control_smallest_share"] for r in out if r["control_smallest_share"] <= 1.0]
    if blind:
        raise AssertionError(f"the flash bound does not see a 2^-5 fault: {blind}")
    return out


def one_call(fn) -> dict:
    """Where one call of ``fn`` spends its time: the host clock of a warmed
    call ending in a synchronize, then the card's busy time, idle share and
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
            "device_kernels": sum(c for _, c in rows.values()),
            "top_device_ops": sorted(([k[:80], t / 1e6, c] for k, (t, c) in rows.items()),
                                     key=lambda x: -x[1])[:8]}


def serve_trace(cfg, params, dev, request=SERVE_REQUESTS[0]):
    """Where serving time goes: host clock of a warm prefill of ``request``
    (batch, prompt, generated tokens) and of one decode step after it,
    untraced; then the card's busy time and its largest kernels from a
    traced run of each."""
    from repro_torch.models import api

    b, p, g = request
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (b, p), device=dev, generator=gen)
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(cfg, params, {"tokens": tokens}, p + g)

    def decode():
        tok = state["logits"][:, -1].argmax(dim=-1, keepdim=True)
        api.decode_step(cfg, params, state["cache"], tok, p)

    emit({"phase": "serve_trace", "arch": cfg.name,
          "what": f"warm prefill b{b} x {p} and one decode step",
          "prefill": one_call(prefill), "decode_step": one_call(decode)})


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


def mlstm_work(bh, s, hd, L, elt):
    """(bytes, operations) the chunked cell needs: q, k, v and the gates
    read once, y and (C, n, m) written once; per (b·h, chunk) the C update
    (2·L·hd²), q·C where C is not zero (2·L·hd² past the first chunk), the
    causal halves of q·kᵀ and W·v (2·2·L(L+1)/2·hd), and q·n and the n
    update (2·2·L·hd)."""
    nc = s // L
    nbytes = 4 * bh * s * hd * elt + 2 * bh * s * 4 + bh * (hd * hd + hd + 1) * 4
    per_chunk = 2 * L * hd * hd + 2 * L * (L + 1) * hd + 4 * L * hd
    ops = bh * (nc * per_chunk + (nc - 1) * 2 * L * hd * hd)
    return nbytes, ops


def mlstm_split_work(bh, s, hd, L):
    """The bfloat16 kernel's operations by the rate they can run at:
    (products of a float32 operand, three bf16 passes on the tensor cores:
    the C update, q·C past the first chunk and W·v; q·kᵀ, exact in one
    pass; q·n and the n update, on the CUDA cores)."""
    nc = s // L
    split = bh * (nc * 2 * L * hd * hd + (nc - 1) * 2 * L * hd * hd + nc * L * (L + 1) * hd)
    return split, bh * nc * L * (L + 1) * hd, bh * nc * 4 * L * hd


def mlstm_entry(dev, launches, errs):
    """Times and bounds of the mLSTM kernel at the two prefill shapes; the
    headline numbers are the b4 × 512 request's. ``bound_ms`` counts the
    split products at the bf16 tensor-core rate over three passes, q·kᵀ at
    that rate in one, the rest on the CUDA cores; ``bound_ms_f32_cuda_cores``
    is the earlier figure, every operation at the float32 CUDA-core rate."""
    import re

    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
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
        L = min(chunk, s)
        nbytes, ops = mlstm_work(bh, s, hd, L, args[0].element_size())
        split, single, cuda = mlstm_split_work(bh, s, hd, L)
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
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

    by_shape = {}
    for name in ("prefill_d2560", "prefill_q_norm", "prefill_k_norm", "decode_d2560",
                 "xlstm_prefill_d2048", "xlstm_prefill_b1_d2048", "xlstm_decode_d2048"):
        n, d, dtype = RMS_CASES[name]
        x, w = rms_inputs(RMS_CASES[name], dev)
        fn = lambda: rmsnorm_rows_cuda(x, w, 1e-6)  # noqa: E731
        ms, how, seen = kernel_ms(fn, 20, "rmsnorm_")
        # a yardstick only: the port never calls it; its weight is cast to
        # x's type once, outside the timing
        w_lib = w.to(dtype)
        lib = cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-6), 20)
        nbytes = 2 * n * d * x.element_size() + 4 * d
        bound, by = _bound(nbytes, 4 * n * d, PEAK_F32_PER_S)
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
    """Times and bounds of the flash kernel at the two prefill shapes; the
    headline numbers are the b4 × 512 request's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.flash_attention.ref import attention_plain

    by_shape = {}
    for name in ("serve_b4_s512", "serve_b1_s1000"):
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
        pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
        flops = 4 * b * h * pairs * hd
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound, by = _bound(nbytes, flops, PEAK_BF16_PER_S)
        by_shape[name] = {"shape": [b, sq, sk, h, kv, hd], "flops": flops, "ms": ms,
                          "ms_from": how, "profiled_launches": seen,
                          "wrapper_ms": cuda_ms(fn, 10),
                          "plain_ms": cuda_ms(
                              lambda: attention_plain(q, k, v, causal=causal), 5),
                          "bound_ms": bound, "bound_by": by, "library_ms": lib}
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
        "shape": "B 4, S 512, H 32, KV 8, hd 128, causal, bf16; b1 x 1000 below",
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
    one RMSNorm launch per norm site (a step's and a prefill's alike), one
    flash launch per attention layer or one mLSTM launch per mLSTM block a
    prefill."""
    if cfg.family == "ssm":
        norms = cfg.n_layers + 1
        pre = {"flash_attention": 0,
               "mlstm_chunk": cfg.n_layers - cfg.n_layers // cfg.slstm_every}
    else:
        norms = 4 * cfg.n_layers + 1
        pre = {"flash_attention": cfg.n_layers, "mlstm_chunk": 0}
    return ({"rmsnorm": norms, **pre},
            {"rmsnorm": norms, "flash_attention": 0, "mlstm_chunk": 0})


def serve_step_graphs(cfg, params, dev, request):
    """The unplanned path's graphed decode (``_step_fns``, captured by
    serve_path) against the eager masked decode on one request in one
    process: the eager path is fed the graph path's tokens; each step's
    logits must be bitwise equal, or else within one bf16 step of the
    step's largest logit (cuBLAS may pick another algorithm under capture),
    and argmax to the same token. Two requests through the graph add no
    capture. Prints decode ms/token (host clock) and one step of each path
    (host clock, the card's busy time, idle share)."""
    from repro_torch.launch import serve as S
    from repro_torch.models import api

    b, p, g = request
    prompts = S._prompts(cfg, b, p, 0, dev)
    prefill, decode = S._step_fns(cfg.name, False, b, p + g, dev, donate=True)
    trace0 = dict(S.TRACE_COUNT)

    def graphed():
        logits, cache = prefill(params, {"tokens": prompts})
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

    logits, cache = api.prefill(cfg, params, {"tokens": prompts}, p + g)
    e_steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(g - 1):
        logits, cache = api.decode_step(cfg, params, cache, toks[:, i:i + 1], p + i)
        e_steps.append(logits)
    torch.cuda.synchronize()
    e_s = (time.perf_counter() - t0) / (g - 1)
    bitwise = sum(bool(torch.equal(a, e)) for a, e in zip(g_steps, e_steps))
    diffs = [float((a.float() - e.float()).abs().max()) for a, e in zip(g_steps, e_steps)]
    bounds = [BF16_STEP * float(e.float().abs().max()) for e in e_steps]
    same_tokens = all(bool(torch.equal(S._argmax_token(e), toks[:, i + 1:i + 2]))
                      for i, e in enumerate(e_steps))
    row = {"phase": "serve_step_graphs", "arch": cfg.name,
           "request": {"batch": b, "prompt": p, "gen": g},
           "steps": g - 1, "bitwise_equal_steps": bitwise,
           "max_abs_diff": max(diffs), "bound": min(bounds),
           "bound_rule": "one bf16 step (2^-7) of the step's largest |logit|",
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
          and all(d <= bd for d, bd in zip(diffs, bounds)))
    if not ok:
        raise AssertionError(f"{cfg.name}: graphed decode check failed")


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
    S.PlannedExecutor(cfg.name, planner, device=dev, params={0: params}).warmup(
        [(b, p, g, 0)], cycle_budget=budget)
    S.serve(cfg.name, b, p, g, device=dev, params=params)   # warms the unplanned key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = S.serve(cfg.name, b, p, g, device=dev, params=params)
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
    got = S.serve(cfg.name, b, p, g, device=dev, params=params, plan_table=planner,
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
    cap = S._step_fns(cfg.name, False, b, p + g, dev, donate=False)[1]._graphs[params]
    feed_ms = cuda_ms(lambda: cap.feed(state["cache"], state["tok"], p), 5)
    clone_ms = cuda_ms(lambda: S._map(torch.clone, cap.cache), 5)
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
    ex = S.PlannedExecutor(cfg.name, table, device=dev, params={0: params})
    plan = ex.planner.plan_for(b, p + g, None)
    _, e_req = request_energy(plan, g, None, ex.planner.e_startup)
    harness = TrafficHarness(ex, harvest=HarvestModel(capacity=1.5 * e_req, rate=0.9 * e_req),
                             keep_tokens=True)
    reqs = deterministic_arrivals(TRAFFIC_ARRIVALS, 0.0, (b, p, g))
    harness.warmup(reqs)
    want = S.serve(cfg.name, b, p, g, device=dev, params=params).numpy()
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
    return launches


def main() -> int:
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
    qwen_flash_cells(cfg, params, dev)
    serve_parity(cfg, params, dev)
    serve_trace(cfg, params, dev)
    serve_step_graphs(cfg, params, dev, SERVE_REQUESTS[0])
    time_tables = {t["arch"]: t["table"] for t in built if t["kind"] == "time"}
    launches_by_path = {SERVE_ARCH: serve_launches}
    launches_by_path[f"{SERVE_ARCH} planned"] = serve_planned(
        cfg, params, dev, time_tables[SERVE_ARCH], *PLANNED[SERVE_ARCH])
    launches_by_path[f"{SERVE_ARCH} traffic"] = traffic_path(
        cfg, params, dev, time_tables[SERVE_ARCH])
    del params
    torch.cuda.empty_cache()

    # -- phases 12-17: the xLSTM path: mLSTM kernel, serving, checks, trace ---
    mlstm_err = mlstm_kernel_checks(dev)
    xcfg = get_config(XLSTM_ARCH)
    xparams, xlstm_launches = serve_path(dev, xcfg, XLSTM_REQUESTS, *xlstm_expected(xcfg))
    xlstm_layer_checks(xcfg, xparams, dev)
    xlstm_f32_parity(xcfg, xparams, dev)
    xlstm_bf16_parity(xcfg, xparams, dev)
    serve_trace(xcfg, xparams, dev, XLSTM_REQUESTS[0])
    serve_step_graphs(xcfg, xparams, dev, XLSTM_REQUESTS[0])
    launches_by_path[XLSTM_ARCH] = xlstm_launches
    launches_by_path[f"{XLSTM_ARCH} planned"] = serve_planned(
        xcfg, xparams, dev, time_tables[XLSTM_ARCH], *PLANNED[XLSTM_ARCH])
    del xparams
    torch.cuda.empty_cache()

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
        "launches": launches["partition_sweep"] + plan_launches,
        "launches_by_path": {"headcount": launches["partition_sweep"],
                             "plan_table": plan_launches},
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
