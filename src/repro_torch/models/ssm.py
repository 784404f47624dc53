"""The Mamba2 (SSD) block of zamba2 (``repro/models/ssm.py``).

Prefill runs the chunkwise SSD form: within a chunk of ``CHUNK`` positions
the recurrence is a masked quadratic form; across chunks the state [B, H,
P, N] is carried by a host loop over the chunks, where ``repro`` runs a
``lax.scan``. Decode is the single-step recurrence. Both share one
discretization, so decode continues prefill: a prompt prefilled in part
and fed the rest token by token reaches the state of one whole prefill.

The SSD is plain tensor code in both packages (no kernel), with
``repro``'s types: the projections and the causal depthwise conv in
bfloat16 (the conv's four taps added in ``repro``'s order, then ``silu`` in
float32), ``A_log``, ``dt_bias`` and ``D`` read as float32, the
discretization ``softplus(dt + dt_bias)`` and ``A = -exp(A_log)`` in
float32, the intra-chunk scores rounded to bfloat16 before their product
with x, the inter-chunk state and its contributions in float32, and the
output rounded to bfloat16 before the ``silu(z)`` gate.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import COMPUTE_DTYPE, PARAM_DTYPE, dense_init, frozen, ones_init, zeros_init

__all__ = ["CHUNK", "CONV_K", "Mamba2", "init_mamba", "mamba_dims", "mamba_chunk_len",
           "mamba_init_state"]

CHUNK = 128
CONV_K = 4  # causal depthwise conv window
State = Dict[str, torch.Tensor]


def mamba_dims(cfg) -> Tuple[int, int, int, int]:
    """(d_in, H, P, N): inner width, heads, head width, state size."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    return d_in, d_in // P, P, cfg.ssm_state


def mamba_chunk_len(seq: int) -> int:
    """The chunk a prompt of ``seq`` tokens is cut into: ``CHUNK``, or the
    whole prompt below it; a longer prompt must be a multiple of it."""
    L = min(CHUNK, seq)
    if seq < 1 or seq % L:
        raise ValueError(f"a Mamba2 prompt of {seq} tokens: the length must be a multiple "
                         f"of the {CHUNK}-token chunk, or at most {CHUNK}")
    return L


def init_mamba(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    d_in, H, _, N = mamba_dims(cfg)
    return {"in_proj": dense_init(gen, (d, 2 * d_in + 2 * N + H)),  # z, x, B, C, dt
            "conv_w": dense_init(gen, (CONV_K, d_in + 2 * N), scale=0.5),
            "A_log": zeros_init(gen, (H,)), "dt_bias": zeros_init(gen, (H,)),
            "D": ones_init(gen, (H,)), "out_proj": dense_init(gen, (d_in, d))}


def mamba_init_state(cfg, batch: int, device) -> State:
    """The zero state, float32: "ssm" [B, H, P, N] and the conv's trailing
    context "conv" [B, CONV_K − 1, d_in + 2N]."""
    d_in, H, P, N = mamba_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros(batch, H, P, N, **f32),
            "conv": torch.zeros(batch, CONV_K - 1, d_in + 2 * N, **f32)}


class Mamba2(nn.Module):
    """The Mamba2 block with its projections: normed x [B, S, d] → [B, S, d]."""

    def __init__(self, cfg, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in ("in_proj", "conv_w", "out_proj"):
            setattr(self, name, frozen(p[name], COMPUTE_DTYPE))
        for name in ("A_log", "dt_bias", "D"):
            setattr(self, name, frozen(p[name], PARAM_DTYPE))

    def dims(self) -> Tuple[int, int, int, int]:
        """(d_in, H, P, N) of the heads this block computes."""
        return mamba_dims(self.cfg)

    def zero_state(self, batch: int, device) -> State:
        """:func:`mamba_init_state` for this block's heads."""
        return mamba_init_state(self.cfg, batch, device)

    def _split_proj(self, x):
        """x [..., d] → (z [..., d_in], xBC [..., d_in + 2N], dt [..., H])."""
        d_in, H, _, N = self.dims()
        return (x @ self.in_proj).split([d_in, d_in + 2 * N, H], dim=-1)

    def _cb(self, Cc, Bc):
        """The intra-chunk C·Bᵀ over the state: [B, nc, L, N] × 2 → [B, nc, L, L]."""
        return torch.einsum("bcin,bcjn->bcij", Cc, Bc)

    def _discretize(self, dt):
        """dt [..., H] → (log decay per step A·dt ≤ 0, effective dt), float32."""
        dt_eff = F.softplus(dt.float() + self.dt_bias.float())
        return -torch.exp(self.A_log.float()) * dt_eff, dt_eff

    def _conv(self, xbc, conv_state: torch.Tensor):
        """Causal depthwise conv over the sequence of xbc [B, S, F], after the
        trailing context ``conv_state`` [B, CONV_K − 1, F]. Returns
        (silu(conv) in bfloat16, the new trailing context)."""
        s = xbc.shape[1]
        xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
        out = sum(xp[:, i:i + s] * self.conv_w[i] for i in range(CONV_K))
        return F.silu(out.float()).to(COMPUTE_DTYPE), xp[:, -(CONV_K - 1):]

    def _gate_out(self, y, z):
        """y [B, S, d_in] float32 → bfloat16, gated by silu(z), projected."""
        y = y.to(COMPUTE_DTYPE) * F.silu(z.float()).to(COMPUTE_DTYPE)
        return y @ self.out_proj

    def forward(self, x, state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
        """Prefill: (y [B, S, d], final state) from ``state`` (zeros when
        None). S must be a multiple of ``CHUNK``, or at most ``CHUNK``."""
        d_in, H, P, N = self.dims()
        b, s, _ = x.shape
        L = mamba_chunk_len(s)
        nc = s // L
        if state is None:
            state = self.zero_state(b, x.device)
        z, xbc, dt = self._split_proj(x)
        xbc, conv_state = self._conv(xbc, state["conv"])
        xs, Bm, Cm = xbc.split([d_in, N, N], dim=-1)
        xc = xs.reshape(b, nc, L, H, P)
        logdec, dt_eff = self._discretize(dt)                  # [B, S, H]
        Bc = Bm.reshape(b, nc, L, N).float()
        Cc = Cm.reshape(b, nc, L, N).float()
        dtc = dt_eff.reshape(b, nc, L, H)

        cum = logdec.reshape(b, nc, L, H).cumsum(dim=2)       # inclusive
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B, nc, Li, Lj, H]
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        # masked before the exp: the upper triangle's cum_i − cum_j > 0 overflows
        seg = seg.masked_fill(~causal[None, None, :, :, None], float("-inf"))
        cb = self._cb(Cc, Bc)
        scores = cb[..., None] * torch.exp(seg) * dtc[:, :, None, :, :]
        y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(COMPUTE_DTYPE), xc)

        # inter-chunk: each chunk's contribution to the state, Σ_j decay_j dt_j B_j ⊗ x_j
        weight = torch.exp(cum[:, :, -1:, :] - cum) * dtc      # [B, nc, L, H]
        contrib = torch.einsum("bcln,bclhp->bchpn", Bc, xc.float() * weight[..., None])
        chunk_decay = torch.exp(cum[:, :, -1, :])              # [B, nc, H]
        s_run = state["ssm"].float()
        before = []                                            # the state entering each chunk
        for c in range(nc):
            before.append(s_run)
            s_run = s_run * chunk_decay[:, c, :, None, None] + contrib[:, c]
        y_inter = (torch.einsum("bcln,bchpn->bclhp", Cc, torch.stack(before, dim=1))
                   * torch.exp(cum)[..., None])

        y = y_intra.float() + y_inter + xc.float() * self.D.float()[:, None]
        return self._gate_out(y.reshape(b, s, d_in), z), {"ssm": s_run, "conv": conv_state}

    def decode(self, x, state: State) -> Tuple[torch.Tensor, State]:
        """One token x [B, 1, d]: the single-step recurrence → (y [B, 1, d],
        the next state, float32 "ssm" and the bfloat16 trailing context)."""
        d_in, H, P, N = self.dims()
        b = x.shape[0]
        z, xbc, dt = self._split_proj(x)
        xbc, conv_state = self._conv(xbc, state["conv"])
        xs, Bm, Cm = xbc.split([d_in, N, N], dim=-1)
        xh = xs.reshape(b, H, P).float()
        logdec, dt_eff = self._discretize(dt[:, 0])            # [B, H]
        s = (state["ssm"].float() * torch.exp(logdec)[:, :, None, None]
             + (dt_eff[:, :, None] * xh)[..., None] * Bm[:, 0].float()[:, None, None, :])
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), s) + xh * self.D.float()[:, None]
        return self._gate_out(y.reshape(b, 1, d_in), z), {"ssm": s, "conv": conv_state}
