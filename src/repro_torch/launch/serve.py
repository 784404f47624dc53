"""Batched serving: one prefill builds the padded KV cache, then
greedy decode steps extend it.

    python -m repro_torch.launch.serve [--arch qwen3-4b|xlstm-1.3b] [--batch 4]
        [--prompt-len 32] [--gen 16] [--smoke] [--device cuda]

The unplanned path of ``repro/launch/serve.py::serve``, for qwen3-4b (dense,
KV cache) and xlstm-1.3b (recurrent state; its prompt length must be a
multiple of 128 or below 128). Without ``--smoke`` the architecture runs at
its full width (qwen3-4b: 36 layers, d 2560, 4,411,417,600 parameters;
xlstm-1.3b: 48 layers, d 2048) with random weights from ``--seed``;
``--smoke`` takes the small config of the same architecture. The planned path
(``--plan-table``, energy cycles under the burst runtime) waits for the
port's plan tables (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import resolve_config
from ..device import resolve_device
from ..models import api

__all__ = ["serve", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int, prompt_len: int, gen: int, *, smoke: bool = False,
          seed: int = 0, device="cuda", params=None, report: Optional[dict] = None) -> torch.Tensor:
    """Serve one batched request; returns the generated tokens [batch, gen]
    (int64, on the host). The cache is the KV cache or the recurrent state,
    as the architecture's family has it.

    Parameters come from ``api.init_params(cfg, seed)`` unless ``params``
    (a model already on ``device``) is given; the prompts are drawn from a
    generator seeded with ``seed + 1``. ``report`` (a dict) receives the
    prefill time and the decode time per token in milliseconds, host clock
    around work that ends in a synchronize.
    """
    if gen < 1:
        raise ValueError("gen must be >= 1 (prefill emits the first token)")
    dev = resolve_device(device)
    cfg = resolve_config(arch, smoke=smoke)
    max_seq = prompt_len + gen
    if params is None:
        params = api.init_params(cfg, seed, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, {"tokens": prompts}, max_seq)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    _sync(dev)
    t_pre = time.perf_counter() - t0

    out = [tok]
    t1 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, params, cache, tok, prompt_len + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
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
    args = ap.parse_args(argv)
    serve(args.arch, args.batch, args.prompt_len, args.gen, smoke=args.smoke,
          seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
