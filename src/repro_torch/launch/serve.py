"""Batched serving: one prefill builds the padded KV cache (recurrent state
for xLSTM), then greedy decode steps extend it; optionally scheduled from a
precomputed plan table.

    python -m repro_torch.launch.serve [--arch ARCH] [--batch 4]
        [--prompt-len 32] [--gen 16] [--full] [--device cuda]
        [--plan-table plan.npz [--energy-budget E]
         [--calibration ledger.json [--drift-tol 0.05]]]
        [--trace-out t.json] [--metrics-out m.json]

The port of ``repro/launch/serve.py``, for all ten architectures of
``repro``: qwen3-4b, tinyllama-1.1b, deepseek-coder-33b and qwen1.5-0.5b
(dense, KV cache), granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b (moe),
llama-3.2-vision-11b (vlm: a zero stand-in of 1601 vision tokens,
cross-attention caches), whisper-large-v3 (encdec: a zero stand-in of 1500
audio frames), xlstm-1.3b (ssm: recurrent state) and zamba2-7b (hybrid:
Mamba2 states beside one KV cache per application of the shared attention
block; a cache without tail blocks has ``"tail": None``, which the decode
graph, the state packets and the NVMs carry as it is). The ssm and hybrid
prompts must be at most 128 tokens or a multiple of 128, as ``repro``'s
chunked prefills assert: :func:`serve` refuses other lengths before any
work. As in ``repro``, the CLI and :func:`serve`
default to the small config of the architecture (``--smoke`` is accepted
and changes nothing); ``--full`` (``serve(smoke=False)``) runs it at its
full width (qwen3-4b: 36 layers, d 2560, 4,411,417,600 parameters;
xlstm-1.3b: 48 layers, d 2048) with random weights from ``--seed``, made
by ``api.init_params(cfg, seed, max_seq=prompt + gen)`` as ``repro`` makes
them (``max_seq`` sizes whisper's decoder positions). So the planner CLI's
default table serves under this CLI's default.

**Step functions.** ``repro`` jits prefill and decode once per shape
(``_step_fns``). Here :func:`_step_fns` caches, per (arch, smoke, batch,
max_seq, device, donate), a prefill and a decode that on a card are each
one CUDA graph replay. A decode graph is captured once per parameters
object, a prefill graph once per parameters object and input shapes
(tokens [B, S] and the vlm's or encdec's stand-in), so one entry may hold
several prefill graphs. Each capture follows one eager step on a side
stream, whose result the call returns; later calls copy their inputs into
the graph's static inputs (the cache, token and 0-d position of a decode)
and replay it. A prefill hands back clones of its logits and cache, a
decode a clone of its logits and the graph's own cache (a clone of it
unless ``donate``). On the CPU both are the eager functions.
``TRACE_COUNT`` counts, never calls: on the CPU builds of the step
functions, on a card captures of their graphs (one per model and
input shape, as ``repro`` counts a trace per shape). The cells of
``launch/steps.py``, whole or laid out over a device mesh
(``launch/mesh.py``), are CUDA graphs on a card through :func:`_capture`
too.

**Planned path.** With ``--plan-table`` the request is energy-bounded: its
shape is bucketed into a :class:`repro_torch.core.plan_table.PlanTable` (an
O(1) lookup: no partitioner solve and no capture on the request path), the
token steps are grouped into cycles that fit ``--energy-budget``, and the
request runs as a task graph under
:class:`repro_torch.core.runtime.BurstRuntime`: every cycle boundary
commits the decode state to NVM, so a power failure mid-request resumes
from the last committed cycle. The executor keys its models on (seed,
max_seq), as ``repro`` does. The planned path never donates: a decode
task copies the state it reads into the graph's inputs and emits a copy of
what the graph wrote, so nothing the runtime stores or reloads is a buffer
a later replay overwrites. Scheduling changes, results never do: planned
and unplanned serving give the same tokens.

**Calibration.** ``--calibration`` (with ``--plan-table``) takes a measured
profile — a calibration JSON (``MeasuredCostTable.to_json``, e.g. of
``MeasuredCostTable.from_ledger_json`` on the traffic harness's
``--ledger-out``) — and, before serving, probes the table against it
(:func:`calibration_probe`): a table whose cycles the measurements price
more than ``--drift-tol`` away is refused.
"""

from __future__ import annotations

import argparse
import functools
import time
import weakref
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..configs import ALL_ARCHS, resolve_config
from ..device import resolve_device
from ..models import api
from ..models.sharding import is_dtensor
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from .traffic import Continuation, Request

__all__ = ["serve", "main", "PlannedExecutor", "TRACE_COUNT", "reset_trace_counts",
           "calibration_probe"]

# Builds of the step functions on the CPU, captures of their graphs on a
# card (never calls): the serving tests pin these at zero across repeated
# planned and unplanned requests of one shape. Registry-backed, a dict to
# callers.
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
    """The leaves of a nested dict, in order; a None (a cache part the
    config does not have) has none."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _map(fn, tree):
    """``fn`` on every leaf of a nested dict; a None stays None."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


PROMPT_CHUNK = 128  # the ssm and hybrid families' prefill chunk (repro's assert)


def _check_prompt_len(cfg, prompt_len: int) -> None:
    """Raises ValueError for a prompt the family's prefill cannot take:
    the ssm (chunked mLSTM) and hybrid (chunked SSD) families take at most
    ``PROMPT_CHUNK`` tokens or a multiple of it."""
    if (cfg.family in ("ssm", "hybrid") and prompt_len > PROMPT_CHUNK
            and prompt_len % PROMPT_CHUNK):
        raise ValueError(f"{cfg.name}: a prompt of {prompt_len} tokens; the {cfg.family} "
                         f"family's chunked prefill takes at most {PROMPT_CHUNK} tokens or "
                         f"a multiple of {PROMPT_CHUNK}")


def _feed(static, given, where: str = "input") -> None:
    """Copy ``given`` into the static tensors ``static`` leaf by leaf
    (nested dicts of one layout). A leaf that is its static tensor already
    is not copied, a number fills a 0-d leaf, a None stays None, and a
    tensor of another shape raises ValueError. A DTensor leaf (a sharded
    cell's) takes a DTensor of the same placements, each device's block
    copied into its own; other placements raise ValueError."""
    if isinstance(static, Mapping):
        for k, v in static.items():
            _feed(v, given[k], f"{where}.{k}")
    elif static is None:
        if given is not None:
            raise ValueError(f"{where}: the graph has None here")
    elif given is not static:
        if not isinstance(given, torch.Tensor):
            static.fill_(given)
        elif given.shape != static.shape:
            raise ValueError(f"{where} {tuple(given.shape)}, graph has {tuple(static.shape)}")
        elif is_dtensor(static):
            if not is_dtensor(given) or tuple(given.placements) != tuple(static.placements):
                raise ValueError(f"{where}: placements {getattr(given, 'placements', None)}, "
                                 f"graph has {tuple(static.placements)}")
            static.to_local().copy_(given.to_local())
        else:
            static.copy_(given)


class _Captured:
    """One captured step: its static inputs (a nested dict of tensors that
    each call's inputs are copied into), the outputs its capture left (a
    nested dict that each replay overwrites), the graph's ``replay``, the
    kernel launches one replay makes, and what the capture cost
    (``stats``). Nothing here needs a card: the CPU tests give it an eager
    ``replay``."""

    def __init__(self, inputs):
        self.inputs = _map(torch.empty_like, inputs)
        self.outputs = None
        self.replay = None
        self.launches = ()
        self.stats: Dict[str, float] = {}

    def feed(self, inputs) -> None:
        _feed(self.inputs, inputs)

    def __call__(self, inputs):
        """Copy ``inputs`` in, replay, add the launches the graph holds to
        the kernels' counts; returns a clone of every output, since a later
        replay overwrites the graph's own."""
        self.feed(inputs)
        self.replay()
        for fn, n in self.launches:
            fn.launches += n
        return _map(torch.clone, self.outputs)


def _capture(step, inputs, dev: torch.device, like=None):
    """``step(static inputs) -> outputs`` (a nested dict of tensors) as a
    CUDA graph → (the :class:`_Captured`, the warm-up's outputs, which are
    this call's result). The static inputs are made like ``like`` (default
    ``inputs``: ``like`` gives a 0-d tensor where ``inputs`` holds a
    number) and fed ``inputs``; :func:`_record` captures."""
    cap = _Captured(inputs if like is None else like)
    cap.feed(inputs)
    return cap, _record(step, cap, dev)


def _record(step, cap: _Captured, dev: torch.device):
    """The warm-up, the eager step on a side stream that PyTorch's capture
    needs, on ``cap``'s static inputs: it makes the request's real launches
    and result (and every kernel's one-time shared-memory opt-in, every
    NCCL communicator a sharded step uses, DTensor's sharding decisions),
    which it returns. Then the capture of ``step`` into ``cap``'s graph; it
    launches nothing (a sharded step's NCCL collectives are recorded, not
    run), so the kernels' launch counts are set back after it.
    ``cap.stats``: the seconds spent recording (``capture_s``) and ending
    the capture with the graph's instantiation (``instantiate_s``), the
    bytes the allocator reserved for the graph's private pool
    (``pool_bytes``), and its peak of allocated bytes (since the last
    ``reset_peak_memory_stats``) once the warm-up was enqueued, before the
    capture (``warmup_peak_bytes``). A failure raises: nothing drops to
    eager."""
    from ..kernels import launch_counters
    from ..kernels._build import load_library

    load_library()  # no build or load under capture
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = step(cap.inputs)
    main.wait_stream(side)
    for t in _leaves(out):
        (t.to_local() if is_dtensor(t) else t).record_stream(main)
    warmup_peak = torch.cuda.max_memory_allocated(dev)

    counters = launch_counters()
    before = [fn.launches for fn in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):  # synchronizes and empties the cache first
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            cap.outputs = step(cap.inputs)
            t1 = time.perf_counter()
        cap.stats = {"capture_s": t1 - t0, "instantiate_s": time.perf_counter() - t1,
                     "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
                     "warmup_peak_bytes": warmup_peak}
        cap.launches = tuple((fn, fn.launches - n) for fn, n in zip(counters, before)
                             if fn.launches != n)
    finally:
        for fn, n in zip(counters, before):
            fn.launches = n
    cap.replay = graph.replay
    return out


class _GraphedDecode:
    """Decode on a card: a CUDA graph per parameters object and input shapes
    (the graph holds the weights' addresses; it goes when the model does),
    its static inputs the cache, the token and a 0-d position. A shape's
    first call captures (:func:`_capture`) and returns the warm-up's
    result. Each call returns the logits and the graph's own cache, or a
    clone of it unless ``donate``. ``step(params, cache, tok, pos) ->
    (logits, cache)``, the eager step it captures, defaults to
    ``api.decode_step``; ``graphs(params)``: {input key: :class:`_Captured`}
    of a model."""

    def __init__(self, cfg, dev: torch.device, donate: bool, step=None):
        self.cfg, self.dev, self.donate = cfg, dev, donate
        self.step = step or (lambda params, cache, tok, pos:
                             api.decode_step(cfg, params, cache, tok, pos))
        self._graphs: "weakref.WeakKeyDictionary[Any, Dict[tuple, _Captured]]" = (
            weakref.WeakKeyDictionary())

    def graphs(self, params) -> Dict[tuple, _Captured]:
        return self._graphs.setdefault(params, {})

    def __call__(self, params, cache, tok, pos):
        inputs = {"cache": cache, "tok": tok, "pos": pos}
        graphs = self.graphs(params)
        key = tuple((tuple(t.shape), t.dtype) for t in _leaves({"cache": cache, "tok": tok}))
        cap = graphs.get(key)
        if cap is None:
            eager = self.step

            def step(s):
                return {"logits": eager(params, s["cache"], s["tok"], s["pos"])[0]}

            like = inputs
            if not isinstance(pos, torch.Tensor):
                like = {**inputs, "pos": torch.zeros((), dtype=torch.int64, device=self.dev)}
            cap, out = _capture(step, inputs, self.dev, like=like)
            graphs[key] = cap
            TRACE_COUNT["decode"] += 1
            logits = out["logits"]
        else:
            logits = cap(inputs)["logits"]
        cache = cap.inputs["cache"]
        return logits, (cache if self.donate else _map(torch.clone, cache))


def _input_key(inputs) -> tuple:
    """A prefill graph's key: each input's name, shape and dtype."""
    return tuple((k, tuple(t.shape), t.dtype) for k, t in sorted(inputs.items()))


class _GraphedPrefill:
    """Prefill on a card: a CUDA graph per parameters object and input
    shapes (``tokens`` [B, S] and the vlm's or encdec's stand-in), kept in
    a ``WeakKeyDictionary`` on the parameters object so that the graphs go
    when the model does. A shape's first call captures (:func:`_capture`)
    and returns the warm-up's result; later calls copy their inputs into
    the graph's and replay it, and each hands back clones of the logits and
    of every cache leaf (a None leaf stays None). ``step(params, inputs) ->
    (logits, cache)``, the eager step it captures, defaults to
    ``api.prefill`` padding the cache to ``max_seq``. ``graphs(params)``:
    {input key: :class:`_Captured`} of a model, for the captures' stats."""

    def __init__(self, cfg, dev: torch.device, max_seq: int, step=None):
        self.cfg, self.dev, self.max_seq = cfg, dev, max_seq
        self.step = step or (lambda params, inputs: api.prefill(cfg, params, inputs, max_seq))
        self._graphs: "weakref.WeakKeyDictionary[Any, Dict[tuple, _Captured]]" = (
            weakref.WeakKeyDictionary())

    def graphs(self, params) -> Dict[tuple, _Captured]:
        return self._graphs.setdefault(params, {})

    def __call__(self, params, inputs):
        graphs = self.graphs(params)
        key = _input_key(inputs)
        cap = graphs.get(key)
        if cap is None:
            eager = self.step

            def step(s):
                logits, cache = eager(params, s)
                return {"logits": logits, "cache": cache}

            cap, out = _capture(step, inputs, self.dev)
            graphs[key] = cap
            TRACE_COUNT["prefill"] += 1
        else:
            out = cap(inputs)
        return out["logits"], out["cache"]


def _eager_decode(cfg, donate: bool, params, cache, tok, pos):
    if not donate:
        cache = _map(torch.clone, cache)
    return api.decode_step(cfg, params, cache, tok, pos)


@functools.lru_cache(maxsize=None)
def _step_fns(arch: str, smoke: bool, batch: int, max_seq: int, device: torch.device,
              donate: bool = False):
    """Cached (prefill, decode) for both serving paths, per (arch, smoke,
    batch, max_seq, device, donate).

    ``prefill(params, _pre_batch(cfg, tokens [batch, S]))`` and
    ``decode(params, cache, tok [batch, 1], pos)`` return (logits, cache).
    On a card each replays a CUDA graph (:class:`_GraphedPrefill`,
    :class:`_GraphedDecode`); on the CPU both run eagerly.
    ``donate=True`` (the unplanned path) hands back the cache decode wrote
    in place (the graph's own static cache on a card), the counterpart of
    ``repro``'s cache donation; ``donate=False`` (the planned path) leaves
    its input cache untouched and returns a new one, so a replayed cycle
    can re-read the committed cache. Always pass ``donate=`` by keyword:
    ``lru_cache`` keys positional and keyword calls apart.
    """
    cfg = resolve_config(arch, smoke=smoke)
    if device.type == "cuda":
        return _GraphedPrefill(cfg, device, max_seq), _GraphedDecode(cfg, device, donate)

    def prefill(params, inputs):
        return api.prefill(cfg, params, inputs, max_seq)

    TRACE_COUNT["prefill"] += 1
    TRACE_COUNT["decode"] += 1
    return prefill, functools.partial(_eager_decode, cfg, donate)


def _prompts(cfg, batch: int, prompt_len: int, seed: int, dev: torch.device) -> torch.Tensor:
    """The request's prompts: token ids from a generator seeded ``seed + 1``."""
    return torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1))


def _pre_batch(cfg, prompts) -> Dict[str, Any]:
    """The prefill's inputs: the tokens and, as ``repro`` feeds them, zero
    stand-ins for the vlm's vision tokens and encdec's audio frames
    (``api.extra_inputs``), on the prompts' device."""
    out: Dict[str, Any] = {"tokens": prompts}
    for name, (shape, dtype) in api.extra_inputs(cfg, prompts.shape[0]).items():
        out[name] = torch.zeros(shape, dtype=dtype, device=prompts.device)
    return out


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
    models by (seed, max_seq) as ``repro`` keys them (made on first use by
    ``api.init_params(cfg, seed, max_seq=max_seq)``, or handed in as
    ``params``: {(seed, max_seq): model on ``device``}), and the
    process-wide step-function cache. It
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
        self._params: Dict[Any, Any] = dict(params or {})
        self._next_rid = 0

    def _params_for(self, seed: int, max_seq: int):
        key = (seed, max_seq)
        if key not in self._params:
            self._params[key] = api.init_params(self.cfg, seed, self.device, max_seq=max_seq)
        return self._params[key]

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

        _check_prompt_len(self.cfg, prompt_len)
        max_seq = prompt_len + gen
        if plan is None:
            plan = self.planner.plan_for(batch, max_seq, cycle_budget)
        params = self._params_for(seed, max_seq)
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
                         params=None if params is None else {(seed, prompt_len + gen): params})
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


def serve(arch: str, batch: int, prompt_len: int, gen: int, *, smoke: bool = True,
          seed: int = 0, device="cuda", params=None, plan_table=None,
          energy_budget: Optional[float] = None, nvm=None, crash_hook=None,
          report: Optional[dict] = None) -> torch.Tensor:
    """Serve one batched request; returns the generated tokens [batch, gen]
    (int64, on the host). The cache is the KV cache or the recurrent state,
    as the architecture's family has it.

    ``smoke`` takes the architecture's small config (the default, as in
    ``repro``); ``smoke=False`` its full width. Parameters come from
    ``api.init_params(cfg, seed, max_seq=prompt_len + gen)`` unless ``params``
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
    _check_prompt_len(cfg, prompt_len)
    max_seq = prompt_len + gen
    if params is None:
        params = api.init_params(cfg, seed, dev, max_seq=max_seq)
    prompts = _prompts(cfg, batch, prompt_len, seed, dev)
    prefill, decode = _step_fns(arch, smoke, batch, max_seq, dev, donate=True)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, _pre_batch(cfg, prompts))
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


def calibration_probe(plan_table, arch: str, measured, *, smoke: bool = True,
                      device="cuda", drift_tol: float = 0.05, k: Optional[int] = 4,
                      seed: int = 0) -> int:
    """Probe ``plan_table`` (path or PlanTable) against the ``measured``
    profile before serving: ``k`` cells (``None``: all) re-solved on the
    engine of ``device`` (the sweep kernel on a card, its plain version on
    the CPU), each cycle repriced under the measured mean model. Raises
    ``StaleTableError`` when a cycle drifts beyond ``drift_tol``; returns
    the number of cells probed and prints the reference's probe line."""
    from ..core.plan_table import PlanTable, probe_plan_table
    from .planner import _BACKEND_OF_DEVICE

    table = PlanTable.load(plan_table) if isinstance(plan_table, str) else plan_table
    backend = _BACKEND_OF_DEVICE[resolve_device(device).type]
    n = probe_plan_table(table, resolve_config(arch, smoke=smoke), k=k, seed=seed,
                         backend=backend, measured=measured, drift_tol=drift_tol)
    where = plan_table if isinstance(plan_table, str) else table.summary()
    print(f"[serve] calibration probe: {n} cells of {where} within {drift_tol:.1%} "
          f"of the measured profile ({measured.n_samples} samples) — serving", flush=True)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-4b",
                    help="one of: " + ", ".join(ALL_ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="xlstm-1.3b and zamba2-7b: at most 128 or a multiple of 128")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full width instead of its small config")
    ap.add_argument("--smoke", action="store_true",
                    help="the small config (the default; kept for older command lines)")
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
                    help="measured-cost calibration JSON (MeasuredCostTable.to_json): "
                         "probe the plan table against the measured profile before "
                         "serving and refuse stale plans (requires --plan-table)")
    ap.add_argument("--drift-tol", type=float, default=0.05,
                    help="relative drift tolerance for the --calibration probe "
                         "(default 0.05)")
    args = ap.parse_args(argv)
    if args.trace_out:
        TRACER.configure(enabled=True)
    if args.calibration:
        if not args.plan_table:
            ap.error("--calibration requires --plan-table")
        from ..core.calibration import MeasuredCostTable

        calibration_probe(args.plan_table, args.arch,
                          MeasuredCostTable.from_json(args.calibration),
                          smoke=not args.full, device=args.device,
                          drift_tol=args.drift_tol)
    serve(args.arch, args.batch, args.prompt_len, args.gen, smoke=not args.full,
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
