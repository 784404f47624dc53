"""Batched serving: one prefill builds the padded KV cache (recurrent state
for xLSTM), then greedy decode steps extend it; optionally scheduled from a
precomputed plan table.

    python -m repro_torch.launch.serve [--arch qwen3-4b|xlstm-1.3b] [--batch 4]
        [--prompt-len 32] [--gen 16] [--smoke] [--device cuda]
        [--plan-table plan.npz [--energy-budget E]] [--trace-out t.json]
        [--metrics-out m.json]

The port of ``repro/launch/serve.py``, for qwen3-4b (dense, KV cache) and
xlstm-1.3b (recurrent state; its prompt length must be a multiple of 128 or
below 128). Without ``--smoke`` the architecture runs at its full width
(qwen3-4b: 36 layers, d 2560, 4,411,417,600 parameters; xlstm-1.3b: 48
layers, d 2048) with random weights from ``--seed``; ``--smoke`` takes the
small config of the same architecture.

**Step functions.** ``repro`` jits prefill and decode once per shape
(``_step_fns``). Here :func:`_step_fns` caches, per (arch, smoke, batch,
max_seq, device, donate), an eager prefill and a decode that on a card is
one CUDA graph replay: captured once per parameters object after one eager
step on a side stream, its cache, token and 0-d position tensor static
inputs that each call copies into. On the CPU both are the eager
functions. ``TRACE_COUNT`` counts builds and captures, never calls, as
``repro``'s counts retraces. ``repro``'s ``launch/steps.py`` and
``launch/mesh.py`` have no counterpart on one card: their sharding
constraints are TPU mesh rules (ROADMAP.md queue 1, item 9).

**Planned path.** With ``--plan-table`` the request is energy-bounded: its
shape is bucketed into a :class:`repro_torch.core.plan_table.PlanTable` (an
O(1) lookup: no partitioner solve and no capture on the request path), the
token steps are grouped into cycles that fit ``--energy-budget``, and the
request runs as a task graph under
:class:`repro_torch.core.runtime.BurstRuntime`: every cycle boundary
commits the decode state to NVM, so a power failure mid-request resumes
from the last committed cycle. The planned path never donates: a decode
task copies the state it reads into the graph's inputs and emits a copy of
what the graph wrote, so nothing the runtime stores or reloads is a buffer
a later replay overwrites. Scheduling changes, results never do: planned
and unplanned serving give the same tokens.
"""

from __future__ import annotations

import argparse
import functools
import time
import weakref
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..configs import resolve_config
from ..device import resolve_device
from ..models import api
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from .traffic import Continuation, Request

__all__ = ["serve", "main", "PlannedExecutor", "TRACE_COUNT", "reset_trace_counts"]

# Builds of the step functions and captures of the decode graph (never
# calls): the serving tests pin these at zero across repeated planned and
# unplanned requests of one shape. Registry-backed, a dict to callers.
TRACE_COUNT = METRICS.counter_dict("serve.trace_count", ("prefill", "decode"))


def reset_trace_counts() -> None:
    """Zero the build and capture counters (test isolation); the cached step
    functions and their graphs stay. ``repro_torch.obs.metrics.reset_all()``
    covers it too."""
    TRACE_COUNT.reset()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_key(dev: torch.device) -> torch.device:
    """One cache key per card: ``cuda`` is the current card's index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _Captured:
    """One decode graph: its static inputs (cache, token, position), its
    output logits, and the kernel launches one replay makes."""

    def __init__(self, cache, tok, dev):
        self.cache = _map(torch.empty_like, cache)
        self.tok = torch.empty_like(tok)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        self.logits = None
        self.launches = ()

    def feed(self, cache, tok, pos) -> None:
        """Copy a call's inputs into the static ones; a cache that is the
        static one already (the unplanned path hands it back) is not
        copied."""
        if tok.shape != self.tok.shape:
            raise ValueError(f"token shape {tuple(tok.shape)}, graph has "
                             f"{tuple(self.tok.shape)}")
        for dst, src in zip(_leaves(self.cache), _leaves(cache)):
            if src is not dst:
                if src.shape != dst.shape:
                    raise ValueError(f"cache leaf {tuple(src.shape)}, graph has "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        self.tok.copy_(tok)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))


class _GraphedDecode:
    """Decode on a card: a CUDA graph per parameters object (the graph holds
    the weights' addresses; it goes when the model does).

    The first call of a model runs the step eagerly on a side stream, the
    warm-up PyTorch's graph capture needs, and returns its result: those
    are real launches of the request. It then captures the step into the
    graph; a capture launches nothing, so the kernels' launch counts are
    set back, and each replay adds the launches the graph holds. A capture
    or replay that fails raises: nothing drops to eager.
    """

    def __init__(self, cfg, dev: torch.device, donate: bool):
        self.cfg, self.dev, self.donate = cfg, dev, donate
        self._graphs: "weakref.WeakKeyDictionary[Any, _Captured]" = weakref.WeakKeyDictionary()

    def __call__(self, params, cache, tok, pos):
        cap = self._graphs.get(params)
        if cap is None:
            cap, logits = self._capture(params, cache, tok, pos)
            self._graphs[params] = cap
        else:
            cap.feed(cache, tok, pos)
            cap.graph.replay()
            for fn, n in cap.launches:
                fn.launches += n
            logits = cap.logits.clone()
        return logits, (cap.cache if self.donate else _map(torch.clone, cap.cache))

    def _capture(self, params, cache, tok, pos):
        from ..kernels import launch_counters
        from ..kernels._build import load_library

        load_library()  # no build or load under capture
        cap = _Captured(cache, tok, self.dev)
        cap.feed(cache, tok, pos)
        main = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits, _ = api.decode_step(self.cfg, params, cap.cache, cap.tok, cap.pos)
        main.wait_stream(side)
        logits.record_stream(main)

        counters = launch_counters()
        before = [fn.launches for fn in counters]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                cap.logits, _ = api.decode_step(self.cfg, params, cap.cache, cap.tok, cap.pos)
            cap.launches = tuple((fn, fn.launches - n) for fn, n in zip(counters, before)
                                 if fn.launches != n)
        finally:
            for fn, n in zip(counters, before):
                fn.launches = n
        cap.graph = graph
        TRACE_COUNT["decode"] += 1
        return cap, logits


def _eager_decode(cfg, donate: bool, params, cache, tok, pos):
    if not donate:
        cache = _map(torch.clone, cache)
    return api.decode_step(cfg, params, cache, tok, pos)


@functools.lru_cache(maxsize=None)
def _step_fns(arch: str, smoke: bool, batch: int, max_seq: int, device: torch.device,
              donate: bool = False):
    """Cached (prefill, decode) for both serving paths, per (arch, smoke,
    batch, max_seq, device, donate).

    ``prefill(params, {"tokens": [batch, S]})`` and ``decode(params, cache,
    tok [batch, 1], pos)`` return (logits, cache). On a card decode replays
    a CUDA graph (:class:`_GraphedDecode`); on the CPU both run eagerly.
    ``donate=True`` (the unplanned path) hands back the cache decode wrote
    in place (the graph's own static cache on a card), the counterpart of
    ``repro``'s cache donation; ``donate=False`` (the planned path) leaves
    its input cache untouched and returns a new one, so a replayed cycle
    can re-read the committed cache. Always pass ``donate=`` by keyword:
    ``lru_cache`` keys positional and keyword calls apart.
    """
    cfg = resolve_config(arch, smoke=smoke)

    def prefill(params, inputs):
        return api.prefill(cfg, params, inputs, max_seq)

    TRACE_COUNT["prefill"] += 1
    if device.type == "cuda":
        return prefill, _GraphedDecode(cfg, device, donate)
    TRACE_COUNT["decode"] += 1
    return prefill, functools.partial(_eager_decode, cfg, donate)


def _prompts(cfg, batch: int, prompt_len: int, seed: int, dev: torch.device) -> torch.Tensor:
    """The request's prompts: token ids from a generator seeded ``seed + 1``."""
    return torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1))


def _pre_batch(cfg, prompts) -> Dict[str, Any]:
    """The prefill's inputs. The ported families (dense, ssm) take tokens
    only; ``repro``'s vision and audio stand-ins come with the vlm and
    encdec families (ROADMAP.md queue 1, item 10)."""
    return {"tokens": prompts}


def _cache_nbytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of the decode cache: every (shape, dtype) leaf of
    ``api.cache_shape``."""
    return int(sum(int(np.prod(shape)) * dtype.itemsize
                   for shape, dtype in _leaves(api.cache_shape(cfg, batch, max_seq))))


def _argmax_token(logits) -> torch.Tensor:
    return logits[:, -1].argmax(dim=-1, keepdim=True)


def _request_graph(cfg, params, batch, prompt_len, gen, max_seq,
                   prefill_fn, decode_fn, step_energy):
    """The request as a Ladybirds task graph: task 1 = prefill (emits token
    1), task k = decode step k (emits token k). Each task reads the previous
    decode state packet ``{"cache", "tok", "seq"}`` and writes the next
    (SSA); the last writes the ``sequence`` output. Packet sizes are
    ``repro``'s (tokens counted as int32). Task bodies are pure functions of
    their declared inputs, so replayed cycles are idempotent, the contract
    the runtime's recovery relies on. ``seq`` stays on the device: no task
    waits for the card.
    """
    from ..core.graph import GraphBuilder

    b = GraphBuilder()
    b.packet("prompts", batch * prompt_len * 4, external=True)
    state_bytes = _cache_nbytes(cfg, batch, max_seq) + batch * 4
    for k in range(gen - 1):
        b.packet(f"state{k}", state_bytes)
    b.packet("sequence", batch * gen * 4, keep=True)

    def emit(k: int, cache, tok, seq) -> Dict[str, Any]:
        if k == gen - 1:
            return {"sequence": seq}
        return {f"state{k}": {"cache": cache, "tok": tok, "seq": seq}}

    def mk_prefill():
        def fn(inp):
            logits, cache = prefill_fn(params, _pre_batch(cfg, inp["prompts"]))
            tok = _argmax_token(logits)
            return emit(0, cache, tok, tok)
        return fn

    def mk_decode(k: int):
        def fn(inp):
            st = inp[f"state{k - 1}"]
            logits, cache = decode_fn(params, st["cache"], st["tok"], prompt_len + k - 1)
            tok = _argmax_token(logits)
            return emit(k, cache, tok, torch.cat([st["seq"], tok], dim=1))
        return fn

    b.task("prefill", reads=("prompts",),
           writes=("sequence",) if gen == 1 else ("state0",),
           cost=step_energy, fn=mk_prefill())
    for k in range(1, gen):
        b.task(f"decode{k}", reads=(f"state{k - 1}",),
               writes=("sequence",) if k == gen - 1 else (f"state{k}",),
               cost=step_energy, fn=mk_decode(k))
    return b.build()


class PlannedExecutor:
    """Reusable per-request executor for the planned path.

    Owns what amortizes across a request stream: the resolved config, the
    :class:`~repro_torch.launch.planner.ServePlanner` (O(1) lookups), the
    models by seed (made on first use, or handed in as ``params``: {seed:
    model on ``device``}), and the process-wide step-function cache. It
    :meth:`open`\\ s each request as a
    :class:`~repro_torch.launch.traffic.Continuation` whose energy cycles
    commit one :meth:`~repro_torch.launch.traffic.Continuation.step` at a
    time. :func:`serve` drives one continuation to completion; the traffic
    harness (:class:`repro_torch.launch.traffic.TrafficHarness`) interleaves
    cycles of many.
    """

    def __init__(self, arch: str, plan_table, *, smoke: bool = False, device="cuda",
                 params: Optional[Mapping[int, Any]] = None) -> None:
        from ..core.plan_table import PlanTableError
        from .planner import as_planner

        self.arch = arch
        self.smoke = smoke
        self.device = _device_key(resolve_device(device))
        self.planner = as_planner(plan_table)
        self.cfg = resolve_config(arch, smoke=smoke)
        if self.planner.table.arch != self.cfg.name:
            raise PlanTableError(
                f"plan table was built for {self.planner.table.arch!r} but "
                f"this request is for {self.cfg.name!r}"
            )
        self._params: Dict[int, Any] = dict(params or {})
        self._next_rid = 0

    def _params_for(self, seed: int):
        if seed not in self._params:
            self._params[seed] = api.init_params(self.cfg, seed, self.device)
        return self._params[seed]

    def make_prompts(self, batch: int, prompt_len: int, seed: int = 0) -> torch.Tensor:
        """The prompts :func:`serve` draws for ``seed``."""
        return _prompts(self.cfg, batch, prompt_len, seed, self.device)

    def open(self, batch: int, prompt_len: int, gen: int, *, seed: int = 0,
             cycle_budget: Optional[float] = None, prompts=None, plan=None,
             nvm=None, crash_hook=None) -> Continuation:
        """Open one request as a steppable Continuation.

        ``plan`` short-circuits the table lookup (the harness already looked
        it up on the admission path; passing it back avoids double-counting
        ``planner.stats``). External inputs are seeded only on a fresh NVM
        (committed index 0), so reopening against a mid-request NVM resumes
        rather than restarts: the crash-recovery contract.
        """
        from ..core.burst import burst_detail
        from ..core.cost import CostModel, LinearTransfer
        from ..core.partition import Partition
        from ..core.runtime import BurstRuntime
        from .planner import request_cycles

        max_seq = prompt_len + gen
        if plan is None:
            plan = self.planner.plan_for(batch, max_seq, cycle_budget)
        params = self._params_for(seed)
        if prompts is None:
            prompts = self.make_prompts(batch, prompt_len, seed)
        prefill_fn, decode_fn = _step_fns(self.arch, self.smoke, batch, max_seq, self.device,
                                          donate=False)
        graph = _request_graph(self.cfg, params, batch, prompt_len, gen, max_seq,
                               prefill_fn, decode_fn, step_energy=plan.e_total)
        cycles = request_cycles(gen, plan.e_total, cycle_budget,
                                e_startup=self.planner.e_startup)
        cost = CostModel(e_startup=self.planner.e_startup, read=LinearTransfer(0.0, 0.0),
                         write=LinearTransfer(0.0, 0.0), name="request-cycles")
        part = Partition(cycles, [burst_detail(graph, cost, i, j) for (i, j) in cycles], None)
        rt = BurstRuntime(graph, part, nvm=nvm, cost=cost, crash_hook=crash_hook,
                          device=self.device)
        if rt.nvm.read_index() == 0:
            rt.seed_inputs({"prompts": prompts})
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, batch=batch, prompt_len=prompt_len, gen=gen, seed=seed)
        return Continuation(request=req, plan=plan, cycles=list(cycles), runtime=rt,
                            e_startup=self.planner.e_startup)

    def warmup(self, shapes, cycle_budget: Optional[float] = None) -> None:
        """Run one throwaway request per ``(batch, prompt_len, gen, seed)``
        shape, so builds and captures happen outside any measured or
        admission-controlled window."""
        for (batch, prompt_len, gen, seed) in shapes:
            self.open(batch, prompt_len, gen, seed=seed,
                      cycle_budget=cycle_budget).run_to_completion()


def _serve_planned(arch, batch, prompt_len, gen, smoke, seed, device, params,
                   plan_table, energy_budget, nvm, crash_hook, report):
    ex = PlannedExecutor(arch, plan_table, smoke=smoke, device=device,
                         params=None if params is None else {seed: params})
    cont = ex.open(batch, prompt_len, gen, seed=seed, cycle_budget=energy_budget,
                   nvm=nvm, crash_hook=crash_hook)
    _sync(ex.device)
    t0 = time.perf_counter()
    out = cont.run_to_completion()
    _sync(ex.device)
    dt = time.perf_counter() - t0
    seqs = torch.from_numpy(np.asarray(out))
    print(f"[serve] {arch}: planned batch={batch} prefill({prompt_len} tok)+{gen - 1} "
          f"decode steps in {len(cont.cycles)} energy cycles ({dt * 1e3:.1f} ms total) "
          f"on {ex.device}; plan: {cont.plan.summary()}", flush=True)
    print(f"[serve] first sequences: {seqs[:2, :8].tolist()}", flush=True)
    if report is not None:
        report.update(plan=cont.plan, cycles=list(cont.cycles), seconds=dt,
                      runtime_stats=cont.runtime.stats, planner_stats=dict(ex.planner.stats),
                      nvm=cont.runtime.nvm)
    return seqs


def serve(arch: str, batch: int, prompt_len: int, gen: int, *, smoke: bool = False,
          seed: int = 0, device="cuda", params=None, plan_table=None,
          energy_budget: Optional[float] = None, nvm=None, crash_hook=None,
          report: Optional[dict] = None) -> torch.Tensor:
    """Serve one batched request; returns the generated tokens [batch, gen]
    (int64, on the host). The cache is the KV cache or the recurrent state,
    as the architecture's family has it.

    Parameters come from ``api.init_params(cfg, seed)`` unless ``params``
    (a model already on ``device``) is given; the prompts are drawn from a
    generator seeded with ``seed + 1``. ``plan_table`` (path / PlanTable /
    ServePlanner) switches to the planned path of the module docstring;
    ``energy_budget`` bounds its cycles, and ``nvm`` and ``crash_hook`` go
    to its BurstRuntime (power failures in tests); these three need a
    table. ``report`` (a dict) receives, unplanned, the prefill time and the
    decode time per token in milliseconds (host clock around work that ends
    in a synchronize) and, planned, the plan, cycle bounds, seconds,
    runtime and planner stats, and the NVM.
    """
    if gen < 1:
        raise ValueError("gen must be >= 1 (prefill emits the first token)")
    if plan_table is not None:
        return _serve_planned(arch, batch, prompt_len, gen, smoke, seed, device, params,
                              plan_table, energy_budget, nvm, crash_hook, report)
    planned_only = {"energy_budget": energy_budget, "nvm": nvm, "crash_hook": crash_hook}
    misused = [k for k, v in planned_only.items() if v is not None]
    if misused:
        raise ValueError(
            f"{misused} require plan_table: without a plan table there are "
            "no energy cycles, NVM commits, or crash resumability"
        )
    dev = _device_key(resolve_device(device))
    cfg = resolve_config(arch, smoke=smoke)
    max_seq = prompt_len + gen
    if params is None:
        params = api.init_params(cfg, seed, dev)
    prompts = _prompts(cfg, batch, prompt_len, seed, dev)
    prefill, decode = _step_fns(arch, smoke, batch, max_seq, dev, donate=True)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = _argmax_token(logits)
    _sync(dev)
    t_pre = time.perf_counter() - t0

    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok, prompt_len + i)
        tok = _argmax_token(logits)
        out.append(tok)
    _sync(dev)
    t_dec = time.perf_counter() - t1
    seqs = torch.cat(out, dim=1).cpu()
    ms_tok = t_dec * 1e3 / max(gen - 1, 1)
    print(f"[serve] {arch}: batch={batch} prefill({prompt_len} tok) {t_pre * 1e3:.1f} ms, "
          f"decode {gen - 1} steps {ms_tok:.1f} ms/tok on {dev}", flush=True)
    print(f"[serve] first sequences: {seqs[:2, :8].tolist()}", flush=True)
    if report is not None:
        report.update(prefill_ms=t_pre * 1e3, decode_ms_per_token=ms_tok)
    return seqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small config instead of its full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plan-table", default=None,
                    help="precomputed PlanTable (.npz): the energy-bounded planned path")
    ap.add_argument("--energy-budget", type=float, default=None,
                    help="per-cycle energy budget (units of the table's cost model; "
                         "default: unbounded)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON (Perfetto-loadable)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot as JSON")
    ap.add_argument("--calibration", default=None,
                    help="not supported by the port (ROADMAP.md queue 1, item 6)")
    ap.add_argument("--drift-tol", type=float, default=None,
                    help="not supported by the port (ROADMAP.md queue 1, item 6)")
    args = ap.parse_args(argv)
    if args.calibration is not None or args.drift_tol is not None:
        ap.error("--calibration and --drift-tol need the measured-cost calibration "
                 "(core/calibration.py), which is ROADMAP.md queue 1, item 6 and not "
                 "ported yet")
    if args.trace_out:
        TRACER.configure(enabled=True)
    serve(args.arch, args.batch, args.prompt_len, args.gen, smoke=args.smoke,
          seed=args.seed, device=args.device, plan_table=args.plan_table,
          energy_budget=args.energy_budget)
    if args.trace_out:
        n_events = TRACER.write(args.trace_out)
        print(f"[serve] wrote {n_events} trace events to {args.trace_out}")
    if args.metrics_out:
        METRICS.dump_json(args.metrics_out, tool="serve", arch=args.arch)
        print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
