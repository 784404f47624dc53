"""Mixture-of-Experts: top-k routing with capacity (``repro/models/moe.py``).

The routing is ``repro``'s exactly: router logits in bf16, the softmax in
float32, the top k in ``jax.lax.top_k``'s order (the larger probability
first, the lower expert index first on a tie: bf16 logits tie often), the
gates renormalised over
the chosen experts with a floor of 1e-9. Tokens go in groups of
``min(1024, S)``; each expert has C = max(ceil(k · group · cf / E), 4) slots
a group, filled in the order of the flattened (token, choice) index t·k + j;
a choice at a queue position ≥ C is dropped (adds zero).

``repro`` dispatches and combines with a dense [G, t, k, E, C] one-hot
(about 336 MB in float32 at granite's b4 × 512). Here both go by index: each
kept choice is scattered into its (expert, slot) row, and the expert
outputs are gathered back from the same rows. Every slot holds at most one
choice, so the two give the same sums. The expert products are batched
bf16 matmuls, as ``repro``'s einsums are plain XLA outside any kernel. No
step reads a value on the host, so a decode step stays capturable.

Training adds ``repro``'s Switch-style load-balance loss
(:func:`load_balance_loss`), which the loss scales by 0.01; the routing
itself carries no gradient, the gates and router probabilities do.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import COMPUTE_DTYPE, KERNELS, Kernels, dense_init, frozen

__all__ = ["MoE", "init_moe", "moe_capacity", "route", "Routing", "load_balance_loss",
           "slot_rows", "expert_ffn", "combine", "balance_means", "GROUP_SIZE"]

GROUP_SIZE = 1024


def init_moe(cfg, gen) -> dict:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    return {"router": dense_init(gen, (d, e)), "w1": dense_init(gen, (e, d, ff)),
            "w3": dense_init(gen, (e, d, ff)), "w2": dense_init(gen, (e, ff, d))}


def moe_capacity(m, group: int) -> int:
    """Slots per expert and group."""
    return max(int(math.ceil(m.top_k * group * m.capacity_factor / m.n_experts)), 4)


class Routing(NamedTuple):
    """Each (group, token, choice)'s expert ``sel``, gate, queue position
    ``pos`` and whether it fits (``kept``: pos < C); all [G, t, k]."""

    sel: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor


def route(probs: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """Float32 router probabilities [G, t, E] → :class:`Routing`. The top
    k are taken on a unique int64 key per expert, the probability's bits
    (ordered as its value, since it is not negative) above the reversed
    expert index, so that a tie goes to the lower index, ``jax.lax.top_k``'s
    order, whatever the sort's stability on any device (``torch.topk`` on
    the probabilities leaves it unspecified). Positions are a cumsum over
    the flattened (token, choice) index t·k + j, token-major."""
    g, t, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    key = (probs.contiguous().view(torch.int32).to(torch.int64) << 32) | (e - 1 - experts)
    sel = torch.topk(key, top_k, dim=-1).indices
    gate = torch.gather(probs, -1, sel)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = (sel[..., None] == experts).to(torch.int32)
    # the scan runs along the last axis in int32: along the token axis it
    # was an outer-dim int64 scan, most of an MoE prefill's card time
    queue = onehot.reshape(g, t * top_k, e).transpose(1, 2)
    before = torch.cumsum(queue, dim=-1, dtype=torch.int32) - queue
    pos = (before.transpose(1, 2).reshape(g, t, top_k, e) * onehot).sum(dim=-1)
    return Routing(sel, gate, pos, pos < capacity)


class MoE(nn.Module):
    """Top-k routed SwiGLU experts, weights stacked on the expert axis:
    router [d, E], w1 / w3 [E, d, ff], w2 [E, ff, d], all bf16."""

    def __init__(self, cfg, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in ("router", "w1", "w3", "w2"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))

    def router_probs(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, d] → float32 router probabilities [G, group, E] of its
        token groups."""
        b, s, d = x.shape
        group = min(GROUP_SIZE, s)
        if (b * s) % group:
            raise ValueError(f"{b} x {s} tokens do not split into groups of {group}")
        logits = x.reshape(b * s // group, group, d) @ self.router
        return torch.softmax(logits.to(torch.float32), dim=-1)

    def routing(self, x: torch.Tensor) -> Routing:
        """x [B, S, d] → the routing of its token groups."""
        return self.route_probs(self.router_probs(x))

    def route_probs(self, probs: torch.Tensor) -> Routing:
        """The routing of router probabilities [G, group, E] (float32)."""
        m = self.cfg.moe
        return route(probs, m.top_k, moe_capacity(m, probs.shape[1]))

    def forward(self, x: torch.Tensor, with_aux: bool = False, kernels: Kernels = KERNELS):
        """x [B, S, d] bf16 → [B, S, d] bf16; with ``with_aux``, (that, the
        load-balance loss of the router probabilities, computed again from
        x, and the routing's choices).

        The block runs through ``kernels.experts``: on a mesh that splits
        the experts, each device computes its own experts' slots, the
        tokens exchanged by all-to-all (``sharding.py``); on a mesh that
        does not, on each device's batch block with the experts gathered
        whole. The load-balance loss takes the two means it multiplies over
        every block, as one device takes them over the whole batch."""
        if not with_aux:
            return kernels.experts(self, x)
        y, means = kernels.experts(self, x, means=True)
        return y, self.cfg.moe.n_experts * (means[0] * means[1]).sum()

    def _block(self, x: torch.Tensor, means: bool = False):
        m = self.cfg.moe
        b, s, d = x.shape
        r = self.routing(x)
        g, t, k = r.sel.shape
        e, c = m.n_experts, moe_capacity(m, t)
        row = slot_rows(r, e, c).reshape(g, t * k)
        xg = x.reshape(g, t, 1, d).expand(g, t, k, d).reshape(g, t * k, d)
        xe = x.new_zeros(g, e * c + 1, d)
        xe.scatter_(1, row[..., None].expand(g, t * k, d), xg)
        xe = xe[:, :e * c].reshape(g, e, c, d).transpose(0, 1).reshape(e, g * c, d)
        ye = expert_ffn(xe, self.w1, self.w3, self.w2)
        ye = ye.reshape(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
        ye = torch.cat([ye, ye.new_zeros(g, 1, d)], dim=1)
        picked = torch.gather(ye, 1, row[..., None].expand(g, t * k, d)).reshape(g, t, k, d)
        y = combine(picked, r).reshape(b, s, d)
        if means:
            return y, torch.stack(balance_means(self.router_probs(x), r.sel))
        return y


def slot_rows(r: Routing, n_experts: int, capacity: int) -> torch.Tensor:
    """The (expert, slot) row e·C + pos of each kept choice, like ``r.sel``;
    a dropped choice goes to the spare row E·C past the last, which the
    experts never read."""
    return torch.where(r.kept, r.sel * capacity + r.pos,
                       torch.full_like(r.sel, n_experts * capacity))


def expert_ffn(xe: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """Each expert's SwiGLU on its slots: xe [E, n, d] bf16 against w1 / w3
    [E, d, ff] and w2 [E, ff, d] → [E, n, d] bf16."""
    h = F.silu((xe @ w1).to(torch.float32)).to(COMPUTE_DTYPE) * (xe @ w3)
    return h @ w2


def combine(picked: torch.Tensor, r: Routing, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """The experts' outputs of each choice, picked [..., k, d] bf16, summed
    under the gates (zero where dropped) in float32 → [..., d] in ``dtype``:
    ``repro``'s combine weights are the gates in float32 rounded to bf16."""
    w = torch.where(r.kept, r.gate, torch.zeros_like(r.gate)).to(COMPUTE_DTYPE)
    return (w.to(torch.float32)[..., None] * picked.to(torch.float32)).sum(dim=-2).to(dtype)


def load_balance_loss(probs: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``repro``'s Switch-style auxiliary loss, E · Σ_e (mean probability
    of e) · (mean choices of e per token), over the groups' tokens: probs
    [G, t, E] float32, sel [G, t, k] → 0-d float32."""
    mean_probs, mean_chosen = balance_means(probs, sel)
    return probs.shape[-1] * (mean_probs * mean_chosen).sum()


def balance_means(probs: torch.Tensor, sel: torch.Tensor):
    """(mean probability of each expert, mean choices of each expert per
    token) over the groups' tokens, both [E] float32."""
    chosen = F.one_hot(sel, probs.shape[-1]).to(torch.float32).sum(dim=2)  # [G, t, E]
    return probs.mean(dim=(0, 1)), chosen.mean(dim=(0, 1))
