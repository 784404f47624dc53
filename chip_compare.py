#!/usr/bin/env python3
"""Serving kernels of one checkout on one card, for comparing two commits.

    python3 chip_compare.py <checkout root> <label>

Imports ``repro_torch`` from ``<checkout root>/src`` (building its kernels
there), then prints one JSON line: ``nvcc -Xptxas -v``'s registers and
spills of the flash, RMSNorm, mLSTM, sweep and window-CNN kernels; the chunked-mLSTM
kernel's device time per call (its stages summed, ``torch.profiler``) and
its wrapper's time at xlstm-1.3b's two prefill shapes (bf16); the sweep
kernel's device and wrapper time in each of the head count's three modes
on the full THERMAL graph, and the head count's solve time as its launcher
solves (Q_min, the 9-point Q grid, exact-K; least and median of 3 warm
runs, host clock); the
flash kernel's device time per
launch (``torch.profiler``) and its wrapper's time beside
``scaled_dot_product_attention`` at qwen3-4b's two prefill shapes; the
RMSNorm kernel's device time, and the host-bound times (least and median of
15 rounds of 200 back-to-back calls, CUDA events) of its wrapper, of the
model-layout op and of ``F.rms_norm`` at the serving shapes, with the parts
of the wrapper's host path; a warm full-width qwen3-4b b4 × 512 prefill
and decode step (host clock, and the card's busy time from the profiler);
and the head count's CNN: a warm full-THERMAL ``execute_atomic`` (host
clock, least and median of 3), the batch CNN kernel's device time at
N=5452, and the host-bound time of one CNN task through ``score_window`` and
through the graph's own task body (with the frame wrapper's host parts
where the checkout has it).
Compare two checkouts only within one call to the card, in turns: parent,
change, change, parent. Exits 2 without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, f"{root}/src")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from chip_smoke import cuda_ms, host_ms, kernel_ms, profile_device

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bkv_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda
    from repro_torch.models import api
    from repro_torch.models.common import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = _build.load_library()
    out = {"label": label, "root": root, "build_s": time.perf_counter() - t0,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True, timeout=60).stdout.strip()}
    ptxas = {}
    for src in ("flash_attention/csrc/flash_attention.cu", "rmsnorm/csrc/rmsnorm.cu",
                "mlstm_chunk/csrc/mlstm_chunk.cu", "partition_sweep/csrc/partition_sweep.cu",
                "conv_window/csrc/conv_window.cu"):
        extra = _build._EXTRA.get(Path(src).name, [])
        r = subprocess.run([_build._nvcc(), *_build._FLAGS, *extra, "-Xptxas", "-v", "-c",
                            str(_build._PKG / src),
                            "-o", str(_build.BUILD_ROOT / "ptxas_probe.o")],
                           capture_output=True, text=True, timeout=600)
        entry = None
        for line in r.stderr.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("registers" in line or "spill" in line):
                ptxas.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    out["ptxas"] = ptxas
    out.update(headcount_cnn(dev, lib))
    out.update(mlstm_and_sweep(dev))

    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, s, h, kv, hd) in {"b4_s512": (4, 512, 32, 8, 128),
                                    "b1_s1000": (1, 1000, 32, 8, 128)}.items():
        q = torch.randn(b * kv, s, h // kv, hd, device=dev, generator=gen).to(torch.bfloat16)
        k = torch.randn(b * kv, s, hd, device=dev, generator=gen).to(torch.bfloat16)
        v = torch.randn(b * kv, s, hd, device=dev, generator=gen).to(torch.bfloat16)
        fn = lambda: flash_attention_bkv_cuda(q, k, v, causal=True)  # noqa: E731
        ms, _, seen = kernel_ms(fn, 20, "flash")
        ql = q.reshape(b, kv, s, h // kv, hd).permute(0, 1, 3, 2, 4).reshape(b, h, s, hd)
        kl, vl = (t.reshape(b, kv, s, hd) for t in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            ql, kl, vl, is_causal=True, enable_gqa=True)
        sdpa()
        sdpa_device_ms = sum(t for t, _ in profile_device(
            lambda: [sdpa() for _ in range(20)]).values()) / 20 / 1e3
        out[f"flash_{name}"] = {"ms": ms, "profiled": seen, "wrapper_ms": cuda_ms(fn, 20),
                                "sdpa_ms": cuda_ms(sdpa, 20),
                                "sdpa_device_ms_per_call": sdpa_device_ms}

    for name, (n, d) in {"d2560": (2048, 2560), "q_norm": (65536, 128),
                         "k_norm": (16384, 128), "decode": (4, 2560),
                         "x2048": (2048, 2048)}.items():
        x = (torch.randn(n, d, device=dev, generator=gen) * 3).to(torch.bfloat16)
        w = torch.randn(d, device=dev, generator=gen)
        fn = lambda: rmsnorm_rows_cuda(x, w, 1e-6)  # noqa: E731
        ms, _, seen = kernel_ms(fn, 20, "rmsnorm")
        x3 = x.reshape(1, n, d) if n < 16 else x.reshape(4, n // 4, d)
        w_lib = w.to(torch.bfloat16)  # cast once, outside the timing
        out[f"rms_{name}"] = {
            "ms": ms, "profiled": seen, "wrapper_ms_least_median": host_ms(fn, rounds=15),
            "op_3d_ms_least_median": host_ms(lambda: KERNELS.rmsnorm(x3, w, 1e-6), rounds=15),
            "library_ms_least_median": host_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-6), rounds=15)}
        if name == "decode":
            y = torch.empty_like(x)
            args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, 1e-6, 1)
            stream = torch.cuda.current_stream().cuda_stream
            out["rms_host_parts_ms_least_median"] = {
                "empty_like": host_ms(lambda: torch.empty_like(x), rounds=15),
                "current_stream": host_ms(lambda: torch.cuda.current_stream().cuda_stream, rounds=15),
                "current_device": host_ms(torch.cuda.current_device, rounds=15),
                "ctypes_launch": host_ms(lambda: lib.rmsnorm_launch(*args, stream), rounds=15)}

    cfg = get_config("qwen3-4b")
    params = api.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab, (4, 512), device=dev, generator=gen)
    state = {}

    def prefill():
        state["logits"], state["cache"] = api.prefill(cfg, params, {"tokens": tokens}, 528)

    def decode():
        tok = state["logits"][:, -1].argmax(dim=-1, keepdim=True)
        api.decode_step(cfg, params, state["cache"], tok, 512)

    for name, fn, reps in (("prefill", prefill, 5), ("decode", decode, 15)):
        fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        rows = profile_device(fn)
        out[f"qwen_{name}"] = {
            "host_ms": host, "host_ms_least": min(host),
            "host_ms_median": statistics.median(host),
            "device_busy_ms": sum(t for t, _ in rows.values()) / 1e3,
            "flash_ms": sum(t for k, (t, _) in rows.items() if "flash" in k) / 1e3,
            "rmsnorm_ms": sum(t for k, (t, _) in rows.items() if "rmsnorm" in k) / 1e3,
            "kernels": sum(c for _, c in rows.values())}
    print(json.dumps(out), flush=True)
    return 0


def headcount_cnn(dev, lib) -> dict:
    """The head count's CNN in this checkout: a warm full-THERMAL atomic
    execution, the batch kernel at N=5452, one CNN task's call time."""
    import numpy as np
    import torch

    from chip_smoke import conv_frame_host_parts, cuda_ms, host_ms, kernel_ms

    from repro_torch.core.apps import headcount as hc
    from repro_torch.core.runtime import execute_atomic
    from repro_torch.kernels.conv_window import kernel as conv_kernel
    from repro_torch.launch.headcount import SEED

    g = hc.build_graph(hc.THERMAL, with_fns=True, seed=SEED, device=dev)
    execute_atomic(g, {}, device=dev)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        execute_atomic(g, {}, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    w = hc.weights_to_torch(hc.cnn_weights(0), dev)
    wl = [w[k] for k in ("conv1", "b1", "conv2", "b2", "fc", "fc_b")]
    x = torch.from_numpy(np.random.RandomState(5452).rand(5452, 12, 12).astype(np.float32)).to(dev)
    fn = lambda: conv_kernel.conv_window_scores_cuda(x, *wl)  # noqa: E731
    ms, how, seen = kernel_ms(fn, 20, "conv_window")
    img = np.random.RandomState(SEED).randint(0, 65535, (60, 80)).astype(np.int32)
    norm = hc.normalize(torch.from_numpy(img).to(dev))
    body = next(t.fn for t in g.tasks if t.name == "cnn2_100")
    out = {"headcount_execute_atomic_s": {"runs": secs, "least": min(secs),
                                          "median": statistics.median(secs)},
           "conv_batch_5452": {"ms": ms, "ms_from": how, "profiled": seen,
                               "wrapper_ms": cuda_ms(fn, 20)},
           "cnn_task_ms_least_median": {
               "score_window": host_ms(lambda: hc.score_window(norm, w, 2, 9, 14)),
               "task_body": host_ms(lambda: body({"norm": norm}))}}
    if hasattr(conv_kernel, "conv_window_frame_cuda"):
        from repro_torch.kernels.conv_window.ops import pack_cnn_weights, window_offsets

        packed = pack_cnn_weights(w)
        out["conv_frame_host_parts_ms_least_median"] = conv_frame_host_parts(
            dev, lib, norm, packed, window_offsets(2, 9, 14, (60, 80)))
    return out


def mlstm_and_sweep(dev) -> dict:
    """The chunked-mLSTM kernel at xlstm-1.3b's prefill shapes, the sweep
    kernel in the head count's three modes, and the head count's solve."""
    import numpy as np
    import torch

    from chip_smoke import MLSTM_CASES, cuda_ms, kernel_ms, launch_ms, mlstm_inputs

    from repro_torch.core import partition_torch as pt
    from repro_torch.core.apps import headcount as hc
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
    from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
    from repro_torch.kernels.partition_sweep.ops import budget_lanes, device_slots

    out = {}
    for name in ("serve_b4_s512", "serve_b1_s1024"):
        args = mlstm_inputs(MLSTM_CASES[name], dev)
        fn = lambda: mlstm_chunk_bh_cuda(*args, chunk=128)  # noqa: E731
        stages = launch_ms(fn, 10, "mlstm_")
        out[f"mlstm_{name}"] = {"ms": sum(t for t, _ in stages.values()),
                                "stages": {k[:60]: t for k, (t, _) in stages.items()},
                                "wrapper_ms": cuda_ms(fn, 10)}
        del args
    g = hc.build_graph(hc.THERMAL)
    csr, cm = g.to_csr_arrays(), hc.paper_cost_model()
    qmn = pt.q_min(g, cm, device=dev)
    grid = [qmn] + [float(q) for q in np.geomspace(qmn * 1.01, g.total_task_cost() * 1.05, 7)] + [None]
    a = device_slots(csr, cm, dev)
    sweep = {}
    for mode, qv, k in (("minimax", (), None), ("sum", grid, None), ("exact_k", (qmn,), 18)):
        budget, exact_k, cmax = budget_lanes(qv, mode, k, "sum")
        b = torch.as_tensor(budget).to(dev)
        fn = lambda: sweep_columns_cuda(*a, b, exact_k=exact_k, combine_max=cmax)  # noqa: E731
        ms, how, seen = kernel_ms(fn, 3, "sweep_kernel")
        sweep[mode] = {"nq": len(budget), "ms": ms, "ms_from": how, "profiled": seen,
                       "us_per_column": ms * 1e3 / g.n_tasks, "wrapper_ms": cuda_ms(fn, 3)}
    out["sweep_thermal"] = {**sweep, "ms_3_modes": sum(v["ms"] for v in sweep.values()),
                            "wrapper_ms_3_modes": sum(v["wrapper_ms"] for v in sweep.values())}

    from repro_torch.launch import headcount as launch

    def solve():
        # the launcher's own solve where the checkout has one (through the
        # façade), else the direct calls its launcher made
        if hasattr(launch, "solve_partitions"):
            launch.solve_partitions(g, cm, dev)
            return
        q0 = pt.q_min(g, cm, device=dev)
        res = pt.sweep(g, cm, grid, device=dev)
        pt.exact_k_partition(g, cm, len(res.bounds(0)), q0, device=dev)

    solve()
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out["headcount_solve_s"] = {"runs": secs, "least": min(secs),
                                "median": statistics.median(secs)}
    return out


if __name__ == "__main__":
    sys.exit(main())
