"""AdamW with global-norm clipping (``repro/optim/adamw.py``).

Parameters, gradients and moments are dicts keyed by parameter name; the
parameters are the float32 masters of the training path (``repro``'s
parameters are float32 too, cast to bfloat16 at each use). The arithmetic
is ``repro``'s, in its order, on float32 tensors:

* the global norm is the square root of the per-leaf sums of squares,
  added one after another in the order of the sorted names (``repro``
  adds its leaves in its tree's flatten order, also by sorted key);
* scale = min(1, clip_norm / max(norm, 1e-9)), every gradient times it;
* step (int32) + 1, lr = lr · min(step / warmup_steps, 1), and the bias
  corrections 1 − b^step, all float32;
* m = b1·m + (1 − b1)·g, v = b2·v + (1 − b2)·g², then
  p − lr·(m / b1c / (sqrt(v / b2c) + eps) + weight_decay·p) on every leaf.

Each division is by a tensor on the parameters' device (PyTorch multiplies
by the reciprocal when it divides by a host scalar, which rounds
differently), and nothing reads a device value back to the host. The
update runs in place, one leaf at a time, as plain tensor code: AdamW is
plain XLA in ``repro``. Every tensor of the state keeps its storage, the
step counter too, so a CUDA graph that captured an update (the port's
train step, ``launch/train.py``) updates the same tensors on each replay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """{"m": {name: zeros}, "v": {name: zeros}, "step": 0}: float32 moments
    shaped like each parameter, on its device; step a 0-d int32 tensor."""
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(float32 gradients scaled by min(1, max_norm / max(‖g‖, 1e-9)), ‖g‖),
    ‖g‖ the L2 norm over all leaves as a 0-d float32 tensor."""
    names = sorted(grads)
    total = None
    for n in names:
        s = grads[n].to(torch.float32).square().sum()
        total = s if total is None else total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(_scalar(max_norm, gn) / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: grads[n].to(torch.float32) * scale for n in names}, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict) -> Dict[str, torch.Tensor]:
    """One step on float32 ``params`` and ``state``, both updated in place:
    every parameter, moment and the 0-d int32 counter ``state["step"]``
    (incremented by 1) stays in its own storage. ``grads`` has the same
    names (any float type) and is not modified. Returns {"grad_norm": the
    norm before clipping, "lr": this step's rate}, 0-d float32 tensors on
    the parameters' device."""
    g, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"].add_(1)
    stepf = step.to(torch.float32)
    lr = cfg.lr * torch.clamp(stepf / _scalar(max(cfg.warmup_steps, 1), stepf), max=1.0)
    b1c = 1 - torch.pow(_scalar(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_scalar(cfg.b2, stepf), stepf)
    for n in sorted(params):
        p, m, v, gn = params[n], state["m"][n], state["v"][n], g[n]
        m.mul_(cfg.b1).add_(gn * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(gn.square() * (1 - cfg.b2))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * delta)
    return {"grad_norm": gnorm, "lr": lr}
