#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the main path
(``repro_torch.launch.headcount.run``: partition the full 5458-task THERMAL
head count on the sweep kernel, then execute the Q_min partition under the
burst runtime with one injected power failure, every window scored by the
CNN kernel) and checks it against the port's CPU execution. Each phase
prints one JSON line; the kernels line carries launches, times and bounds
measured in this run; the last line is the device summary. Any mismatch
raises, so the exit code is nonzero. Without a card, or without the rest of
the repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense):
# HBM3 bytes/s; float32 and float64 on the CUDA cores (not tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12

CONV_TOL = 1e-5          # max |Δ| ≤ CONV_TOL · max(1, |score|)
THERMAL_Q_MIN = 0.13196942


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
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only); returns
    {kernel name: (total device µs, count)} of what ran on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def kernel_ms(fn, reps: int, symbol: str):
    """(device ms per launch of the kernel whose name holds ``symbol``, how).
    From the profiler's kernel durations; where the profiler saw no such
    kernel, from :func:`queued_ms`."""
    fn()
    rows = profile_device(lambda: [fn() for _ in range(reps)])
    us = sum(t for k, (t, _) in rows.items() if symbol in k)
    n = sum(c for k, (_, c) in rows.items() if symbol in k)
    if n and us > 0:
        return us / n / 1e3, "profiler"
    return queued_ms(fn, reps), "queued_cuda_events"


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
    from repro_torch.kernels.conv_window.kernel import conv_window_scores_cuda
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
    load_library()
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "build_s": time.perf_counter() - t0})

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

    # -- phase 4: CNN kernel vs its plain version on the card ------------------
    w = hc.weights_to_torch(hc.cnn_weights(0), dev)
    wl = [w[k].contiguous() for k in ("conv1", "b1", "conv2", "b2", "fc", "fc_b")]
    conv_err = {}
    windows = {}
    for n in (1, 5452):
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
    emit({"phase": "conv_vs_plain_on_card", "max_abs_err": conv_err,
          "tolerance": f"{CONV_TOL}*max(1,|score|)"})

    # -- phase 5: the main path ------------------------------------------------
    sweep_columns_cuda.launches = 0
    conv_window_scores_cuda.launches = 0
    t0 = time.perf_counter()
    r = launch.run("thermal", device=dev, emit=emit)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"partition_sweep": sweep_columns_cuda.launches,
                "conv_window": conv_window_scores_cuda.launches}
    g_cpu = hc.build_graph(hc.THERMAL, with_fns=True, seed=launch.SEED, device=cpu)
    head_cpu = int(execute_atomic(g_cpu, {}, device=cpu)["headcount"])
    ok = (r["headcount"] == r["headcount_atomic"] == head_cpu
          and r["power_failures"] == 1 and r["q_min"] == full["thermal"][2]
          and r["partition"].n_bursts == 18)
    emit({"phase": "main_path", "seconds": main_s, "launches": launches,
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
    conv_rows = [(t, c) for k, (t, c) in rows.items() if "conv_window_kernel" in k]
    seen = busy_s > 0  # else the profiler saw no device activity: not measured
    emit({"phase": "execution_trace", "what": "execute_atomic, full THERMAL",
          "host_s": host_s, "device_busy_s": busy_s if seen else None,
          "idle_share": 1.0 - busy_s / host_s if seen else None,
          "conv_kernel_s": sum(t for t, _ in conv_rows) / 1e6,
          "conv_kernel_launches": sum(c for _, c in conv_rows),
          "device_ops": len(rows),
          "top_device_ops": sorted(([k[:80], t / 1e6, c] for k, (t, c) in rows.items()),
                                   key=lambda x: -x[1])[:6]})

    # -- phase 7: times and bounds at the main path's shapes -------------------
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
        ms, how = kernel_ms(fn, 3, "sweep_kernel")
        ms_from.add(how)
        wms = cuda_ms(fn, 3)
        pms = cuda_ms(lambda: sweep_columns_plain(*a, b, exact_k=exact_k, combine_max=cmax), 1)
        nq, n = len(budget), csr.n_tasks
        nbytes = (4 * (n + 1) + 16 * n + 28 * csr.nnz_reads + 8 * nq + 12 * n * nq)
        ops = ops_col + 3 * nq * n * (n + 1) // 2
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F64_PER_S
        by = "operations" if t_ops >= t_bytes else "bytes"
        bound = max(t_bytes, t_ops) * 1e3
        by_mode[objective] = {"nq": nq, "ms": ms, "wrapper_ms": wms, "plain_ms": pms,
                              "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops}
        for key, v in (("ms", ms), ("wrapper_ms", wms), ("plain_ms", pms), ("bound_ms", bound)):
            totals[key] += v
        bound_time[by] += bound
    sweep_entry = {
        "name": "partition_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/partition_sweep/csrc/partition_sweep.cu",
        "replaces": "src/repro/kernels/partition_sweep/kernel.py:78",
        "launches": launches["partition_sweep"], "max_abs_err": sweep_err["max_abs_err"],
        "bests_mismatches": sweep_err["bests_mismatches"],
        "compared_tables": sweep_err["comparisons"],
        **totals, "ms_from": sorted(ms_from),
        "bound_by": max(bound_time, key=bound_time.get), "library_ms": None,
        "library_note": "no single PyTorch call computes the fused sweep + DP",
        "shape": "THERMAL N=5458, nnz=10908; minimax + 9-lane sum + exact-K K=18, summed",
        "by_mode": by_mode,
    }
    conv_by_n = {}
    for n, x in windows.items():
        fn = lambda: conv_window_scores_cuda(x, *wl)  # noqa: E731
        ms, how = kernel_ms(fn, 20, "conv_window_kernel")
        wms = cuda_ms(fn, 20)
        pms = cuda_ms(lambda: conv_window_scores_plain(x, *wl), 20)
        nbytes = n * 144 * 4 + 1265 * 4 + n * 4
        ops = n * 2 * (10 * 10 * 8 * 9 + 3 * 3 * 16 * 72 + 16)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
        conv_by_n[n] = {"ms": ms, "ms_from": how, "wrapper_ms": wms, "plain_ms": pms,
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                        "max_abs_err": conv_err[n]}
    conv_entry = {
        "name": "conv_window", "route": "cuda",
        "source": "src/repro_torch/kernels/conv_window/csrc/conv_window.cu",
        "replaces": "src/repro/kernels/conv_window/kernel.py:37",
        "launches": launches["conv_window"],
        **{k: conv_by_n[1][k] for k in ("max_abs_err", "ms", "ms_from", "wrapper_ms",
                                         "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused CNN",
        "shape": "N=1 window per launch on the main path; batch 5452 below",
        "batch_5452": conv_by_n[5452],
    }
    print(card, flush=True)
    emit({"kernels": [sweep_entry, conv_entry], "card": card})
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
