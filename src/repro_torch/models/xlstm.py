"""xLSTM cells (``repro/models/xlstm.py``): mLSTM (matrix memory) and sLSTM
(scalar memory).

mLSTM prefill runs the chunked cell from the zero state through
``kernels.mlstm`` (the CUDA kernel on a card); decode is the exact
single-step recurrence in float32, plain tensor code as in ``repro``. The
state is matrix memory C [B, H, hd, hd], normalizer n [B, H, hd] and the
log-space stabilizer m [B, H], all float32.

sLSTM has no parallel form (the hidden state feeds back into the gates): a
Python loop over time, where ``repro`` runs a ``lax.scan``; neither has a
kernel.

Each cell computes in the type of its matmul weights (``COMPUTE_DTYPE`` as
made; a float32 copy of the model computes in float32), with gates, states
and norm statistics in float32, rounding where ``repro`` rounds.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import COMPUTE_DTYPE, KERNELS, Kernels, dense_init, frozen

__all__ = ["MLSTMCell", "SLSTMCell", "init_mlstm", "init_slstm", "slstm_init_state"]
State = Dict[str, torch.Tensor]


def _on_batch(a, kernels: Kernels):
    """``a`` laid out on the batch alone (the identity off a mesh)."""
    return kernels.layout(a, "batch", *(None,) * (a.dim() - 1))


def mlstm_dims(cfg) -> Tuple[int, int, int]:
    """(d_in, H, hd): the mLSTM block up-projects by 2."""
    d_in = 2 * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def slstm_dims(cfg) -> Tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


# -- mLSTM ---------------------------------------------------------------------


def init_mlstm(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    d_in, H, _ = mlstm_dims(cfg)
    return {"wq": dense_init(gen, (d, d_in)), "wk": dense_init(gen, (d, d_in)),
            "wv": dense_init(gen, (d, d_in)), "wi": dense_init(gen, (d, H)),
            "wf": dense_init(gen, (d, H)), "wo_gate": dense_init(gen, (d, d_in)),
            "out_proj": dense_init(gen, (d_in, d))}


class MLSTMCell(nn.Module):
    """The mLSTM cell with its projections: normed x [B, S, d] → [B, S, d]."""

    WEIGHTS = ("wq", "wk", "wv", "wi", "wf", "wo_gate", "out_proj")

    def __init__(self, cfg, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in self.WEIGHTS:
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))

    def qkvif(self, x, kernels: Kernels = KERNELS):
        """q, k, v [B, S, H, hd] in x's type (k scaled by hd^-0.5 after the
        projection) and the gate pre-activations i, f [B, S, H] in float32.
        Each projection is laid out on the batch alone, as ``repro`` does."""
        _, H, hd = mlstm_dims(self.cfg)

        def proj(w):
            return _on_batch(kernels.matmul(x, w), kernels)

        q = proj(self.wq).unflatten(-1, (H, hd))
        k = proj(self.wk).unflatten(-1, (H, hd)) * hd ** -0.5
        v = proj(self.wv).unflatten(-1, (H, hd))
        return q, k, v, proj(self.wi).float(), proj(self.wf).float()

    def _out(self, x, h, kernels: Kernels):
        """Output gate and projection: h [B, S, H, hd] → [B, S, d]. The gate
        and the projection's input are laid out on the batch as h is, so
        that no product hands h's gradient back split across its heads."""
        o = torch.sigmoid(_on_batch(kernels.matmul(x, self.wo_gate), kernels).float())
        return kernels.matmul(_on_batch((h.flatten(-2).float() * o).to(x.dtype), kernels),
                              self.out_proj)

    def forward(self, x, kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, State]:
        """Prefill from the zero state: (y [B, S, d], final state). S must be
        a multiple of the 128-token chunk, or below it."""
        h, (C, n, m) = kernels.mlstm(*self.qkvif(x, kernels))
        return self._out(x, h, kernels), {"C": C, "n": n, "m": m}

    def decode(self, x, state: State, kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, State]:
        """One token x [B, 1, d]: the exact recurrence step, in float32 (on
        a mesh, in the state's layout: C's and n's key features split as
        ``repro`` splits them, q·C and q·n reduced over the split)."""
        q, k, v, i_pre, f_pre = (t[:, 0].float() for t in self.qkvif(x, kernels))
        logf = F.logsigmoid(f_pre)
        m_prev = state["m"]
        m_new = torch.maximum(logf + m_prev, i_pre)
        gdec = torch.exp(logf + m_prev - m_new)
        gsrc = torch.exp(i_pre - m_new)
        C = (state["C"] * gdec[..., None, None]
             + gsrc[..., None, None] * (k[..., :, None] * v[..., None, :]))
        n = state["n"] * gdec[..., None] + gsrc[..., None] * k
        num = (q[..., None, :] @ C)[..., 0, :]
        den = (q * n).sum(dim=-1)
        h = num / torch.clamp(den.abs(), min=1.0)[..., None]
        return self._out(x, h[:, None], kernels), {"C": C, "n": n, "m": m_new}


# -- sLSTM ---------------------------------------------------------------------


def init_slstm(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    H, hd = slstm_dims(cfg)
    ff = 4 * d // 3
    return {"w_in": dense_init(gen, (d, 4 * d)),
            "r": dense_init(gen, (H, hd, 4 * hd), scale=0.05),
            "b": torch.zeros(4 * d, device=gen.device),
            "out_proj": dense_init(gen, (d, d)),
            "ff_w1": dense_init(gen, (d, ff)), "ff_w3": dense_init(gen, (d, ff)),
            "ff_w2": dense_init(gen, (ff, d))}


def slstm_init_state(cfg, batch: int, device) -> State:
    H, hd = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    state = {name: torch.zeros(batch, H, hd, **f32) for name in ("c", "n", "h")}
    state["m"] = torch.full((batch, H, hd), -1e30, **f32)
    return state


class SLSTMCell(nn.Module):
    """The sLSTM cell, its output projection and gated feed-forward: normed
    x [B, S, d] → [B, S, d]."""

    WEIGHTS = ("w_in", "r", "b", "out_proj", "ff_w1", "ff_w3", "ff_w2")

    def __init__(self, cfg, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in self.WEIGHTS:
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))

    def _step(self, pre, st: State) -> State:
        """pre [B, 4d] → the next state (its "h" is the step's output)."""
        H, hd = slstm_dims(self.cfg)
        rec = torch.einsum("bhd,hdq->bhq", st["h"].to(self.r.dtype), self.r).float()
        pre = pre.reshape(pre.shape[0], H, 4 * hd).float() + rec
        i_pre, f_pre, z_pre, o_pre = pre.split(hd, dim=-1)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + st["m"], i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(logf + st["m"] - m_new)
        c = f_g * st["c"] + i_g * torch.tanh(z_pre)
        n = f_g * st["n"] + i_g
        h = torch.sigmoid(o_pre) * c / torch.clamp(n.abs(), min=1.0)
        return {"c": c, "n": n, "h": h, "m": m_new}

    def forward(self, x, state: Optional[State] = None,
                kernels: Kernels = KERNELS) -> Tuple[torch.Tensor, State]:
        """(y [B, S, d], final state), strictly sequential over S, from
        ``state`` or the zero state. Decode is the same with S = 1. The
        recurrence, and the feed-forward's down-projection after it, run
        through ``kernels.local``: on a mesh, on each device's batch block,
        where ``repro``'s partitioned HLO keeps them too; the other products
        are laid out by the mesh."""
        pre_all = kernels.matmul(x, self.w_in) + self.b
        hs, st = kernels.local(self._scan, self, pre_all, state, weights=("r",))
        y = kernels.matmul(hs, self.out_proj)
        g = F.gelu(kernels.matmul(y, self.ff_w1).float(), approximate="tanh").to(x.dtype)
        return kernels.local(lambda a: a @ self.ff_w2, self, g * kernels.matmul(y, self.ff_w3),
                             weights=("ff_w2",)), st

    def _scan(self, pre_all, state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
        """The recurrence over pre_all [B, S, 4d] → (h [B, S, d] in
        pre_all's type, final state)."""
        b, s, _ = pre_all.shape
        st = state if state is not None else slstm_init_state(self.cfg, b, pre_all.device)
        hs = []
        for t in range(s):
            st = self._step(pre_all[:, t], st)
            hs.append(st["h"])
        return torch.stack(hs, dim=1).reshape(b, s, self.cfg.d_model).to(pre_all.dtype), st
