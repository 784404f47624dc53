"""Analytic per-layer profiles of the model zoo → Ladybirds task graphs.

The port's copy of ``repro/core/layer_profile.py``, priced with the H100's
constants (:mod:`.cost`). Turns a ModelConfig + (batch, seq) into the
paper's specification model: one task per layer, packets = boundary activations plus the *long-lived*
packets that make dependency-aware partitioning interesting —

* whisper: the encoder output, read by **every** decoder layer (its l_∞ is
  the last decoder layer, the exact analogue of the paper's image packet
  read by ~7300 CNN window tasks);
* llama-vision: the vision embeddings, read by every 5th layer;
* zamba2: the token embeddings, concat-read by all 13 shared-attention
  applications.

Two cost interpretations of the same graph:

* ``time_cost(profile)``  — E_task = seconds of compute at the H100's bf16
  peak; transfers priced by the chosen CostModel (PCIe offload by default).
* ``memory_cost(profile)`` — E_task = transient working bytes; transfers =
  packet bytes; E_s = 0. A burst's "energy" is then its activation working
  set, so Q_max bounds per-segment memory and Q_min is the smallest
  feasible activation budget (§4.4 applied to HBM).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from .cost import PEAK_FLOPS, CostModel, LinearTransfer, h100_host_offload_model
from .graph import GraphBuilder, TaskGraph

__all__ = ["LayerProfile", "profile_model", "build_activation_graph",
           "time_cost_model", "memory_cost_model", "analytical_cost_model",
           "default_cost_model", "lower_config", "lower_zoo", "external_inputs"]

BYTES_ACT = 2  # bf16 activations


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    name: str
    flops: float              # forward FLOPs of this layer
    weight_bytes: int         # parameter bytes (bf16 compute copy)
    act_bytes: int            # boundary activation it produces
    work_bytes: int           # transient working set while executing
    extra_reads: Tuple[str, ...] = ()  # long-lived packet names


def _attn_flops(cfg: ModelConfig, B: int, S: int, causal: bool = True) -> float:
    proj = 2 * B * S * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd \
        + 2 * B * S * cfg.n_heads * cfg.hd * cfg.d_model
    sc = 4 * B * S * S * cfg.n_heads * cfg.hd * (0.5 if causal else 1.0)
    return proj + sc


def _mlp_flops(cfg: ModelConfig, B: int, S: int, ff: Optional[int] = None,
               gated: bool = True) -> float:
    f = ff or cfg.d_ff
    return (3 if gated else 2) * 2 * B * S * cfg.d_model * f


def profile_model(cfg: ModelConfig, B: int, S: int) -> Tuple[
        List[LayerProfile], Dict[str, int]]:
    """Returns (per-layer profiles in execution order, long-lived packets)."""
    d = cfg.d_model
    act = B * S * d * BYTES_ACT
    long_lived: Dict[str, int] = {}
    out: List[LayerProfile] = []

    def attn_w() -> int:
        return (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                + cfg.n_heads * cfg.hd * d) * 2

    if cfg.family in ("dense", "vlm"):
        per_w = attn_w() + 3 * d * cfg.d_ff * 2
        fl = _attn_flops(cfg, B, S) + _mlp_flops(cfg, B, S)
        for i in range(cfg.n_layers):
            extra = ()
            flops_i, w_i = fl, per_w
            if cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
                long_lived.setdefault(
                    "vision", B * cfg.n_vision_tokens * d * BYTES_ACT)
                extra = ("vision",)
                flops_i += (2 * B * S * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                            + 4 * B * S * cfg.n_vision_tokens * cfg.n_heads * cfg.hd)
                w_i += attn_w()
            out.append(LayerProfile(f"layer{i}", flops_i, w_i, act,
                                    4 * act, extra))
    elif cfg.family == "moe":
        m = cfg.moe
        assert m is not None
        per_w = attn_w() + m.n_experts * 3 * d * m.d_ff_expert * 2
        fl = _attn_flops(cfg, B, S) + m.top_k * _mlp_flops(cfg, B, S, m.d_ff_expert)
        for i in range(cfg.n_layers):
            out.append(LayerProfile(f"layer{i}", fl, per_w, act, 6 * act))
    elif cfg.family == "encdec":
        F = cfg.n_audio_frames
        enc_act = B * F * d * BYTES_ACT
        enc_fl = _attn_flops(cfg, B, F, causal=False) + _mlp_flops(cfg, B, F, gated=False)
        enc_w = attn_w() + 2 * d * cfg.d_ff * 2
        for i in range(cfg.n_encoder_layers):
            out.append(LayerProfile(f"enc{i}", enc_fl, enc_w, enc_act, 4 * enc_act))
        long_lived["enc_out"] = enc_act
        dec_fl = (_attn_flops(cfg, B, S)
                  + 2 * B * S * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                  + 4 * B * S * F * cfg.n_heads * cfg.hd
                  + _mlp_flops(cfg, B, S, gated=False))
        dec_w = 2 * attn_w() + 2 * d * cfg.d_ff * 2
        for i in range(cfg.n_layers):
            out.append(LayerProfile(f"dec{i}", dec_fl, dec_w, act, 4 * act,
                                    ("enc_out",)))
    elif cfg.family == "ssm":  # xlstm
        d_in = 2 * d
        m_w = (2 * d * d_in + d_in * d + 2 * d * cfg.n_heads + d * d_in) * 2
        m_fl = 2 * B * S * d * (3 * d_in + d_in) + 4 * B * S * d_in * (d_in // cfg.n_heads)
        s_w = (4 * d * d + d * d + 3 * d * (4 * d // 3)) * 2
        s_fl = 2 * B * S * (4 * d * d + d * d + 2 * d * (4 * d // 3))
        for i in range(cfg.n_layers):
            slstm = cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
            out.append(LayerProfile(
                f"{'slstm' if slstm else 'mlstm'}{i}",
                s_fl if slstm else m_fl, s_w if slstm else m_w, act, 4 * act))
    elif cfg.family == "hybrid":  # zamba2
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_headdim
        m_w = (d * (2 * d_in + 2 * cfg.ssm_state + H) + d_in * d) * 2
        m_fl = 2 * B * S * d * (2 * d_in + 2 * cfg.ssm_state + H) \
            + 2 * B * S * d_in * d + 6 * B * S * d_in * cfg.ssm_state
        long_lived["embed0"] = act
        shared_w = (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                    + cfg.n_heads * cfg.hd * d + 3 * d * cfg.d_ff) * 2
        shared_fl = (2 * B * S * 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                     + 2 * B * S * S * cfg.n_heads * cfg.hd
                     + _mlp_flops(cfg, B, S))
        n_groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        g = 0
        for i in range(cfg.n_layers):
            out.append(LayerProfile(f"mamba{i}", m_fl, m_w, act, 4 * act))
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0 and g < n_groups:
                g += 1
                out.append(LayerProfile(f"shared_attn{g}", shared_fl, shared_w,
                                        act, 4 * act, ("embed0",)))
    else:
        raise ValueError(cfg.family)
    return out, long_lived


def build_activation_graph(
    profiles: List[LayerProfile], long_lived: Dict[str, int],
    kind: str = "time",
) -> TaskGraph:
    """The paper's task graph: task i reads act_{i-1} (+long-lived packets),
    writes act_i. ``kind`` selects the E_task interpretation."""
    b = GraphBuilder()
    for name, nbytes in long_lived.items():
        b.packet(name, nbytes, external=True)
    prev = None
    for i, lp in enumerate(profiles):
        pkt = b.packet(f"act{i}", lp.act_bytes, keep=(i == len(profiles) - 1))
        # memory kind: E_task = the layer's activation retained across the
        # segment's backward sweep — additive over a segment, so a burst's
        # "energy" is its backward working set (saved boundaries are the
        # stores, accounted separately by the planners).
        cost = lp.flops / PEAK_FLOPS if kind == "time" else float(lp.act_bytes)
        reads = ((prev,) if prev else ()) + lp.extra_reads
        b.task(lp.name, reads=reads, writes=(pkt,), cost=cost)
        prev = pkt
    return b.build()


def _host(value):
    """A volatile packet as a host value (tensors are copied off their device)."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value


def _attach_bodies(
    profiles: List[LayerProfile], seed: int
) -> Dict[str, Callable[[Mapping[str, object]], Dict[str, object]]]:
    """Deterministic numeric bodies for a lowered graph (tests/fault injection).

    Each layer body is a pure function of its declared inputs — a fixed random
    projection of the input means through tanh — so partitioned execution must
    reproduce atomic execution bit-for-bit (the Ladybirds no-side-effects
    contract). Values are small (8,) float64 vectors: packet ``nbytes`` is cost
    metadata, the runtime stores whatever the body returns. Inputs may be
    tensors on any device (the runtime's volatile packets); the body reads
    them on the host and computes in numpy, bit for bit as the reference.
    """
    rng = np.random.RandomState(seed)
    fns: Dict[str, Callable[[Mapping[str, object]], Dict[str, object]]] = {}
    for i, lp in enumerate(profiles):
        w = rng.randn(8)
        b = float(rng.randn())
        out_name = f"act{i}"

        def fn(inp, w=w, b=b, out_name=out_name):
            acc = b
            for name in sorted(inp):
                acc += float(np.mean(np.asarray(_host(inp[name]), dtype=np.float64)))
            return {out_name: np.tanh(w * acc)}

        fns[lp.name] = fn
    return fns


def external_inputs(graph: TaskGraph, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic values for every external packet of a lowered graph."""
    rng = np.random.RandomState(seed + 1)
    return {
        name: rng.randn(8)
        for name, p in sorted(graph.packets.items())
        if p.external
    }


def lower_config(
    cfg: Union[ModelConfig, str],
    batch: int = 1,
    seq: int = 256,
    kind: str = "time",
    with_fns: bool = False,
    seed: int = 0,
) -> TaskGraph:
    """Lower a model-zoo config to a partitionable :class:`TaskGraph`.

    Accepts a :class:`ModelConfig` or a registry name. ``kind`` selects the
    E_task interpretation (``"time"`` seconds-at-peak / ``"memory"`` working
    bytes, see module docstring); ``with_fns`` attaches runnable bodies so
    the graph executes under :class:`repro_torch.core.runtime.BurstRuntime`.
    """
    if isinstance(cfg, str):
        from ..configs import get_config

        cfg = get_config(cfg)
    profiles, long_lived = profile_model(cfg, batch, seq)
    graph = build_activation_graph(profiles, long_lived, kind=kind)
    if with_fns:
        fns = _attach_bodies(profiles, seed)
        tasks = [
            dataclasses.replace(t, fn=fns[t.name]) for t in graph.tasks
        ]
        graph = TaskGraph(tasks, graph.packets.values())
    return graph


def lower_zoo(
    batch: int = 1,
    seq: int = 256,
    kind: str = "time",
    with_fns: bool = False,
    configs: Optional[Mapping[str, ModelConfig]] = None,
) -> Dict[str, TaskGraph]:
    """Lower every registered architecture (name → TaskGraph), in one call.

    The resulting graphs batch together through one façade solve
    (``PartitionSpec(graphs=...)``).
    """
    if configs is None:
        from ..configs import REGISTRY

        configs = REGISTRY
    return {
        name: lower_config(cfg, batch, seq, kind=kind, with_fns=with_fns)
        for name, cfg in sorted(configs.items())
    }


def time_cost_model(transfer: CostModel) -> CostModel:
    """Seconds everywhere: E_task already in seconds, transfers per ``transfer``."""
    return transfer


def memory_cost_model() -> CostModel:
    """Bytes everywhere: burst 'energy' = its activation working set."""
    return CostModel(
        e_startup=0.0,
        read=LinearTransfer(c0=0.0, c1=1.0),
        write=LinearTransfer(c0=0.0, c1=1.0),
        name="hbm-bytes",
    )


def analytical_cost_model(kind: str) -> CostModel:
    """The H100 cost model per activation-graph ``kind`` (``"time"`` prices
    PCIe offload transfers, ``"memory"`` counts working bytes)."""
    if kind == "memory":
        return memory_cost_model()
    if kind == "time":
        return h100_host_offload_model()
    raise ValueError(f"unknown graph kind {kind!r}; 'time' or 'memory'")


def default_cost_model(kind: str) -> CostModel:
    """The standard cost model per activation-graph ``kind``, shared by the
    façade's config-lowered specs and the plan-table builders. Without
    calibration (ROADMAP item 6) it is the analytical model."""
    return analytical_cost_model(kind)
