"""Dry run: count every (architecture × shape) cell on one card or per device
of ``repro``'s production meshes, and run the one-card cells that fit
(``repro/launch/dryrun.py``).

``repro`` lowers and compiles each cell for a TPU pod and reads XLA's memory
and cost analyses and its optimized HLO. The port counts each cell's step
on ``meta`` tensors on the host (``launch/steps.py``, ``launch/roofline.py``):
no weights are made and nothing runs on a card. Per cell the record holds
every key of ``repro``'s:

* ``memory`` — ``argument_size_in_bytes`` (the model, train state and
  inputs), ``output_size_in_bytes`` (what the step returns or updates in
  place), ``temp_size_in_bytes`` (the counted peak minus the arguments),
  ``alias_size_in_bytes`` (the arguments updated in place);
* ``cost_analysis`` — the counted ``flops`` and ``bytes accessed``;
* ``collective_*`` — by kind, per device (empty and 0 on one card);
* ``roofline``/``dominant`` — the three terms at the H100's rates;
* ``model_flops_global`` — 6·``active_param_count()``·S·B (decode: ·B),
  ``repro``'s formula, and ``useful_flops_ratio`` against the count;

and the port's own: ``fits`` (arguments plus temp within the card's
memory), ``cards_needed`` by bytes, ``kernel_calls`` (the model kernels the
step calls), ``counted_at`` (the lengths a quadratic fit was solved from,
where the step loops over positions on the host: the sLSTM of the ssm
family, whose count at full length would take many minutes), and for a
cell that fits and ran on the card ``measured`` (``first_step_s``, the
first step with the capture of its CUDA graph, ``step_s``, a replay of it,
``graphed``, the card's ``peak_bytes``, the graph's ``pool_bytes`` and the
eager first step's ``eager_peak_bytes``).
``t_lower_s`` is the time to build the cell, ``t_compile_s`` that of its
count(s). ``--save-hlo`` becomes
``--save-ops``, the counted op tables. ``--check-fit`` also counts each
fitted cell directly at its own length and holds the fit to that count
(minutes per cell: the sLSTM's host loop). The counts run in one worker
process per CPU.

**Per device.** ``--multi-pod single|multi|both`` counts each cell instead
on ``repro``'s production mesh, one pod ("16x16", 256 devices) and/or two
("pod2x16x16", 512): the cell is built sharded (``steps.build_cell(...,
mesh=...)``) on a ``fake`` process group (``mesh.count_mesh``, one worker
process standing in for every device) and the count is one device's: its
``memory``, ``cost_analysis``, collectives by kind (``repro``'s names and
byte convention), ``roofline`` with the collective term over NVLink, and
``useful_flops_ratio`` against ``n_chips`` devices. ``fits`` is one
device's arguments plus temp within one H100; such records have no
``cards_needed`` and run nothing on a card. Every cell is counted directly
at its own length, the ssm ones too: per device the step's numbers are no
quadratic in the length (DTensor picks its layouts by their cost, which
the length changes, and the peak moves from the gathered weights to the
activations), and a fit at short lengths missed the direct counts at
4096 and 32768 tokens on the card machine. Without the flag the records
are the one-card ones ("1card").

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --device cpu
    python -m repro_torch.launch.dryrun --all --device cuda --out build/dryrun
    python -m repro_torch.launch.dryrun --arch xlstm-1.3b --check-fit --device cpu
    python -m repro_torch.launch.dryrun --all --multi-pod both --device cpu --out build/dryrun
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from ..configs import ALL_ARCHS, get_config
from ..configs.base import SHAPES, ShapeConfig, shape_applicable
from ..device import resolve_device
from .mesh import count_mesh, production_shape
from .roofline import dominant_term, fit_quadratic, roofline_terms, storage_bytes
from .steps import CellSpec, build_cell

__all__ = ["run_cell", "main", "count_at", "fit_lengths", "measure", "workers", "Count",
           "CARD_BYTES_CPU"]

MESH = "1card"
# repro's production meshes: record name → multi_pod
PRODUCTION = {"16x16": False, "pod2x16x16": True}
PODS = {"single": ["16x16"], "multi": ["pod2x16x16"], "both": ["16x16", "pod2x16x16"]}
POD_DEVICES = 512
# The card's memory under --device cpu: the H100's 80 GB (on a card,
# torch.cuda.get_device_properties gives its own).
CARD_BYTES_CPU = 80 * 10**9
MLSTM_CHUNK = 128
# The fit's lengths in chunks: three to solve, the fourth to check. One chunk
# is left out: with no carried state the peak falls elsewhere in the step.
FIT_CHUNKS = (2, 3, 4, 5)


@dataclasses.dataclass
class Count:
    """One count of a cell at one length: the integer ``sizes`` (flops,
    bytes, peak, argument, output and alias bytes), the kernel calls, the
    op table, and the seconds to build the cell and to count it."""

    sizes: Dict[str, int]
    kernel_calls: Dict[str, int]
    ops: Dict[str, List[int]]
    build_s: float
    count_s: float


def fit_lengths(cfg, shape: ShapeConfig, check: bool = False,
                mesh: str = MESH) -> Optional[List[int]]:
    """The four lengths a one-card cell is counted at when its step loops
    over positions on the host (the sLSTM blocks of the ssm family, in a
    train step or a prefill), whole mLSTM chunks, and with ``check`` the
    cell's own length beside them; None for a direct count, which every
    cell of a production ``mesh`` takes (module docstring)."""
    if cfg.family != "ssm" or shape.kind == "decode" or mesh != MESH:
        return None
    if shape.seq_len % MLSTM_CHUNK:
        raise ValueError(f"{shape.name}: {shape.seq_len} is not a multiple of the "
                         f"{MLSTM_CHUNK}-token mLSTM chunk")
    lengths = [n * MLSTM_CHUNK for n in FIT_CHUNKS]
    return lengths + [shape.seq_len] if check and shape.seq_len not in lengths else lengths


def count_at(arch: str, shape_name: str, seq_len: int, remat: bool = True,
             mesh: str = MESH) -> Count:
    """The count of cell (``arch``, ``shape_name``) with its length set to
    ``seq_len`` (a worker's task), on one card or per device of the
    production ``mesh`` (a :data:`PRODUCTION` name). Collective bytes and
    counts go into ``sizes`` as "coll_bytes:<kind>" and "coll_count:<kind>"."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if seq_len != shape.seq_len:
        shape = ShapeConfig(f"{shape.name}@{seq_len}", seq_len, shape.global_batch,
                            shape.kind)
    t0 = time.perf_counter()
    # one fake group of the largest mesh's size serves both meshes
    device_mesh = None if mesh == MESH else count_mesh(*production_shape(PRODUCTION[mesh]),
                                                       world=POD_DEVICES)
    cell = build_cell(cfg, shape, "meta", remat=remat, mesh=device_mesh)
    t1 = time.perf_counter()
    outputs, stats = cell.count()
    t2 = time.perf_counter()
    sizes = {"flops": stats.flops, "bytes": stats.bytes, "peak_bytes": stats.peak_bytes,
             "argument_bytes": stats.argument_bytes,
             "output_bytes": storage_bytes((outputs, cell.alias_args())),
             "alias_bytes": storage_bytes(cell.alias_args())}
    for kind, n in stats.coll_count_by_kind.items():
        sizes[f"coll_count:{kind}"] = n
        sizes[f"coll_bytes:{kind}"] = int(stats.coll_bytes_by_kind[kind])
    return Count(sizes, dict(stats.kernel_calls), stats.ops, t1 - t0, t2 - t1)


def card_bytes(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return CARD_BYTES_CPU


def _at_full(cfg, shape: ShapeConfig, counts: Dict[int, Count]) -> Dict[str, int]:
    """The sizes at the cell's own length: its count, or the exact fit."""
    if list(counts) == [shape.seq_len]:
        return counts[shape.seq_len].sizes
    calls = {s: c.kernel_calls for s, c in counts.items()}
    if any(c != calls[min(calls)] for c in calls.values()):
        raise ValueError(f"kernel calls depend on the length: {calls}")
    return fit_quadratic({s: c.sizes for s, c in counts.items()}, shape.seq_len)


def measure(cell: CellSpec, seed: int = 0,
            launches: Optional[Callable[[], Dict[str, int]]] = None) -> Dict[str, Any]:
    """Two steps of ``cell.run`` from materialized arguments: host seconds
    of each (to a synchronize) and whether they were ``graphed``. On a card
    the first step runs the eager step and captures the cell's CUDA graph,
    the second replays it (on the CPU both are eager, ``graphed`` false);
    there also the card's peak bytes over both, the graph's private pool
    among them (``pool_bytes``, the capture's reservation), and the eager
    first step's own peak, before the capture (``eager_peak_bytes``). With
    ``launches`` (a reader of launch counters, {kernel: count}) also what
    the first step ``launched``."""
    dev = cell.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    args = cell.materialize(seed)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rec: Dict[str, Any] = {}
    for key in ("first_step_s", "step_s"):
        before = launches() if launches and key == "first_step_s" else None
        t0 = time.perf_counter()
        out = cell.run(args)
        if cuda:
            torch.cuda.synchronize(dev)
        rec[key] = time.perf_counter() - t0
        del out
        if before is not None:
            rec["launched"] = {k: n - before[k] for k, n in launches().items()}
    graphs = cell.graphs(args[0])
    rec["graphed"] = bool(graphs)
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["pool_bytes"] = sum(cap.stats["pool_bytes"] for cap in graphs.values())
        rec["eager_peak_bytes"] = max(cap.stats["warmup_peak_bytes"] for cap in graphs.values())
    del args, graphs
    if cuda:
        torch.cuda.empty_cache()
    return rec


def _collectives(sizes: Dict[str, int], what: str) -> Dict[str, Any]:
    return {k.split(":", 1)[1]: (float(v) if what == "bytes" else v)
            for k, v in sorted(sizes.items()) if k.startswith(f"coll_{what}:") and v}


def run_cell(arch: str, shape_name: str, device="cuda", save_ops: Optional[str] = None,
             remat: bool = True, counts: Optional[Dict[int, Count]] = None,
             mesh: str = MESH) -> Dict[str, Any]:
    """The record of one cell on ``mesh`` (one card, or a :data:`PRODUCTION`
    mesh per device), from ``counts`` ({length: :class:`Count`}, counted
    here when None); with a card, a one-card cell that fits also runs two
    steps there."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh,
                           "family": cfg.family}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    dev = resolve_device(device)
    one_card = mesh == MESH
    n_chips = 1 if one_card else math.prod(production_shape(PRODUCTION[mesh])[0])
    try:
        if counts is None:
            counts = {s: count_at(arch, shape_name, s, remat, mesh)
                      for s in (fit_lengths(cfg, shape, mesh=mesh) or [shape.seq_len])}
        sizes = _at_full(cfg, shape, counts)
        calls = counts[min(counts)].kernel_calls
        if save_ops:
            os.makedirs(save_ops, exist_ok=True)
            path = os.path.join(save_ops, f"{arch}_{shape_name}_{mesh}.ops.json")
            with open(path, "w") as fh:
                json.dump({"arch": arch, "shape": shape_name, "sizes": sizes,
                           "tables": {str(s): {**c.sizes, "kernel_calls": c.kernel_calls,
                                               "ops": {op: dict(zip(("calls", "flops",
                                                                     "bytes"), row))
                                                       for op, row in sorted(c.ops.items())}}
                                      for s, c in counts.items()}}, fh, indent=1)
        args_b = sizes["argument_bytes"]
        temp_b = sizes["peak_bytes"] - args_b
        total = card_bytes(dev)
        coll_bytes = _collectives(sizes, "bytes")
        coll_total = float(sum(coll_bytes.values()))
        terms = roofline_terms(sizes["flops"], sizes["bytes"], coll_total)
        model_flops = 6 * cfg.active_param_count() * shape.seq_len * shape.global_batch
        if shape.kind == "decode":
            model_flops = 6 * cfg.active_param_count() * shape.global_batch  # 1 token
        rec.update({
            "status": "ok",
            "t_lower_s": round(sum(c.build_s for c in counts.values()), 2),
            "t_compile_s": round(sum(c.count_s for c in counts.values()), 2),
            "n_chips": n_chips,
            "memory": {"argument_size_in_bytes": args_b,
                       "output_size_in_bytes": sizes["output_bytes"],
                       "temp_size_in_bytes": temp_b,
                       "alias_size_in_bytes": sizes["alias_bytes"]},
            "cost_analysis": {"bytes accessed": float(sizes["bytes"]),
                              "flops": float(sizes["flops"])},
            "collective_bytes_by_kind": coll_bytes,
            "collective_count_by_kind": _collectives(sizes, "count"),
            "collective_bytes_total": coll_total,
            "roofline": terms,
            "dominant": dominant_term(terms),
            "model_flops_global": model_flops,
            "useful_flops_ratio": (model_flops / (sizes["flops"] * n_chips)
                                   if sizes["flops"] else None),
            "kernel_calls": dict(calls),
            "card_bytes": total,
            "fits": args_b + temp_b <= total,
        })
        if one_card:
            rec["cards_needed"] = math.ceil((args_b + temp_b) / total)
        if len(counts) > 1:
            rec["counted_at"] = sorted(counts)
        if one_card and rec["fits"] and dev.type == "cuda":
            rec["measured"] = measure(build_cell(cfg, shape, dev, remat=remat))
        print(f"[dryrun] {arch} × {shape_name} × {mesh}: count {rec['t_compile_s']}s  "
              f"dominant={rec['dominant']}  fits={rec['fits']}"
              + (f" (cards {rec['cards_needed']})" if one_card else
                 f" coll={coll_total:.4g}"))
        print(f"  memory: {rec['memory']}")
        print(f"  cost: flops={sizes['flops']:.4g} bytes={sizes['bytes']:.4g} "
              f"kernel_calls={calls}"
              + (f" counted_at={rec['counted_at']}" if "counted_at" in rec else "")
              + (f" measured={rec['measured']}" if "measured" in rec else ""))
    except Exception as e:  # a cell's fault is its record's; the others go on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} × {shape_name} × {mesh}: FAILED {rec['error']}")
    return rec


def workers(n_tasks: int) -> int:
    """Worker processes for ``n_tasks`` counts: one per CPU this process may
    run on, no more than the tasks (1: count inline)."""
    return max(1, min(n_tasks, len(os.sched_getaffinity(0))))


def _counts(cells, remat: bool, check_fit: bool = False,
            meshes=(MESH,)) -> Dict[tuple, Any]:
    """{(arch, shape, mesh): {length: Count} or the exception a count
    raised}, counted in :func:`workers` spawned worker processes."""
    tasks = []
    for arch, shape_name in cells:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        if shape_applicable(cfg, shape)[0]:
            tasks += [(arch, shape_name, s, mesh) for mesh in meshes
                      for s in (fit_lengths(cfg, shape, check_fit, mesh) or [shape.seq_len])]
    out: Dict[tuple, Any] = {}
    jobs = workers(len(tasks))

    def put(task, result):
        key = (task[0], task[1], task[3])
        cell = out.setdefault(key, {})
        if isinstance(cell, dict):
            if isinstance(result, Exception):
                out[key] = result
            else:
                cell[task[2]] = result

    if jobs <= 1:
        for t in tasks:
            try:
                put(t, count_at(t[0], t[1], t[2], remat, t[3]))
            except Exception as e:  # recorded in the cell's record
                put(t, e)
        return out
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        # the longest counts first: those that loop over positions on the
        # host by their length, then a mesh's train cells, then the rest
        def order_key(t):
            shape = SHAPES[t[1]]
            if fit_lengths(get_config(t[0]), shape):
                return -t[2]
            return -1 if t[3] != MESH and shape.kind == "train" else 0

        futures = {pool.submit(count_at, t[0], t[1], t[2], remat, t[3]): t
                   for t in sorted(tasks, key=order_key)}
        for f in concurrent.futures.as_completed(futures):
            try:
                put(futures[f], f.result())
            except Exception as e:  # recorded in the cell's record
                put(futures[f], e)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="architecture id, or ids joined by commas (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--save-ops", default=None,
                    help="directory for each cell's counted op tables")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--device", default="cuda",
                    help="where a cell that fits runs (cpu: counts only)")
    ap.add_argument("--check-fit", action="store_true",
                    help="also count each fitted cell at its own length (slow)")
    ap.add_argument("--multi-pod", choices=sorted(PODS), default=None,
                    help="count per device of repro's production mesh(es) instead of one "
                         "card: single 16x16, multi 2x16x16, or both")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    archs = args.arch.split(",") if args.arch else list(ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    meshes = PODS[args.multi_pod] if args.multi_pod else [MESH]
    counted = _counts(cells, not args.no_remat, args.check_fit, meshes)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mesh in meshes:
            c = counted.get((arch, shape, mesh))
            if isinstance(c, Exception):
                rec = {"arch": arch, "shape": shape, "mesh": mesh,
                       "family": get_config(arch).family, "status": "error",
                       "error": f"{type(c).__name__}: {c}"}
                print(f"[dryrun] {arch} × {shape} × {mesh}: FAILED {rec['error']}")
            else:
                rec = run_cell(arch, shape, args.device, save_ops=args.save_ops,
                               remat=not args.no_remat, counts=c, mesh=mesh)
            if rec["status"] == "error":
                failures += 1
            if args.out:
                fn = f"{arch}_{shape}_{rec['mesh']}.json".replace("/", "-")
                with open(os.path.join(args.out, fn), "w") as fh:
                    json.dump(rec, fh, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
