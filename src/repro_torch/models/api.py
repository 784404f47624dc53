"""Model API: one entry point each for init / loss / prefill / decode,
dispatched on ``cfg.family`` (``repro/models/api.py``), plus
:func:`extra_inputs` (the modality stand-ins' shapes) and
:func:`params_from_numpy`, which carries the reference's parameters across.

Training holds the float32 masters beside the serving module, which keeps
its weights' types (bfloat16 matmul weights, float32 norms):
:func:`init_trainable` and :func:`trainable_from_numpy` return the module,
its parameters now requiring grad, and {name: the unrounded float32 value}
of each; :func:`load_masters` casts the masters into the module after each
update, so the forward sees the bfloat16 values ``repro``'s cast at each
use gives, and each bfloat16 ``.grad`` in float32 is ``repro``'s cotangent
through that cast. :func:`loss` runs :data:`~.common.PLAIN` unless told
otherwise: ``repro``'s loss reaches no Pallas kernel, and the CUDA kernels
have no backward.

Every family of ``repro`` is ported: dense, moe and vlm
(``transformer``), encdec (``encdec``), and the ssm (xLSTM) and hybrid
(Zamba2) families (``recurrent``).

``init_params(cfg, None, device="meta")`` is ``repro``'s abstract
``init_params(cfg, None)``: the module on ``meta``, its parameters' names,
shapes and types those of a seeded model, and no numbers;
:func:`input_specs` gives a dry-run cell's inputs as (shape, dtype).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import encdec, recurrent, transformer
from .common import (COMPUTE_DTYPE, KERNELS, PLAIN, AbstractGenerator, Kernels,
                     recording_sources)

__all__ = ["init_params", "params_from_numpy", "init_trainable", "trainable_from_numpy",
           "load_masters", "loss", "prefill", "decode_step", "cache_shape", "extra_inputs",
           "input_specs", "TOKEN_DTYPE", "param_logical", "cache_logical"]

TOKEN_DTYPE = torch.int64  # the port's token ids (``repro``'s are int32)


def _module(cfg):
    """The module that runs ``cfg``'s family."""
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer
    if cfg.family == "encdec":
        return encdec
    if cfg.family in ("ssm", "hybrid"):
        return recurrent
    raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(cfg, seed: Optional[int] = 0, device="cuda", max_seq: int = 4096):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the numbers differ from ``repro``'s ``PRNGKey(seed)``; use
    :func:`params_from_numpy` to run the reference's parameters).
    ``max_seq`` sizes encdec's decoder positions, as in ``repro``; the other
    families take no part of it. ``seed=None`` builds the module without
    numbers on ``device="meta"`` (any other device raises)."""
    module = _module(cfg)
    if seed is None:
        if torch.device(device).type != "meta":
            raise ValueError(f"a model without numbers (seed None) is built on 'meta', "
                             f"not {device!r}")
        gen = AbstractGenerator()
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    with torch.no_grad():
        if cfg.family == "hybrid":
            return recurrent.init_zamba_lm(cfg, gen)
        if module is recurrent:
            return recurrent.init_xlstm_lm(cfg, gen)
        if module is encdec:
            return encdec.init_encdec(cfg, gen, max_seq=max_seq)
        return transformer.init_lm(cfg, gen)


def extra_inputs(cfg, batch: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The modality stand-ins a prefill takes beside the tokens, as
    (shape, dtype): vlm's precomputed patch embeddings ("vision"), encdec's
    frame embeddings ("audio")."""
    out = {}
    if cfg.family == "vlm":
        out["vision"] = ((batch, cfg.n_vision_tokens, cfg.d_model), COMPUTE_DTYPE)
    if cfg.family == "encdec":
        out["audio"] = ((batch, cfg.n_audio_frames, cfg.d_model), COMPUTE_DTYPE)
    return out


def input_specs(cfg, shape) -> Dict[str, Any]:
    """A dry-run cell's inputs as (shape, dtype), ``repro``'s ``input_specs``
    in the port's convention (token ids :data:`TOKEN_DTYPE`):

    train:   {"tokens", "labels" [B, S], extra...}
    prefill: {"tokens" [B, S], extra...}
    decode:  {"token" [B, 1], "pos" (), "cache": :func:`cache_shape` (B, S)}

    ``extra`` is :func:`extra_inputs` (vlm's "vision", encdec's "audio")."""
    b, s = shape.global_batch, shape.seq_len
    tok = ((b, s), TOKEN_DTYPE)
    if shape.kind == "train":
        return {"tokens": tok, "labels": tok, **extra_inputs(cfg, b)}
    if shape.kind == "prefill":
        return {"tokens": tok, **extra_inputs(cfg, b)}
    if shape.kind == "decode":
        return {"token": ((b, 1), TOKEN_DTYPE), "pos": ((), TOKEN_DTYPE),
                "cache": cache_shape(cfg, b, s)}
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def _per_layer(stacked, i, t):
    """Layer ``i`` of a tree stacked on axis 0, as tensors."""
    if isinstance(stacked, Mapping):
        return {k: _per_layer(v, i, t) for k, v in stacked.items()}
    return t(stacked[i])


def _map_tree(tree, t):
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, t) for k, v in tree.items()}
    return t(tree)


def params_from_numpy(cfg, tree: Mapping[str, Any], device="cuda"):
    """``repro``'s parameter tree (``init_params(cfg, key)[0]``) as nested
    dicts of numpy arrays → the port's model. Dense and moe: ``layers``
    stacked on axis 0 (moe's ``router``, ``w1``/``w3``/``w2`` stacked on E
    beneath). vlm: ``groups.self`` stacked [n_groups, per − 1, ...],
    ``groups.cross`` [n_groups, ...]. encdec: ``enc`` and ``dec`` stacked,
    ``enc_ln``, ``dec_ln``, ``pos_enc``, ``pos_dec``. xLSTM: ``groups.m``
    stacked [groups, blocks, ...], ``groups.s`` and ``groups.s_ln`` stacked
    [groups, ...]. Zamba2: ``groups.mamba`` (``cell`` and ``ln``) stacked
    [groups, attn_every, ...], ``tail`` [rem, ...] (absent without a tail),
    ``shared`` (``shared.mlp`` in it) unstacked."""
    module = _module(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    with torch.no_grad():
        if cfg.family == "hybrid":
            return _zamba_from_numpy(cfg, tree, t)
        if module is recurrent:
            return _xlstm_from_numpy(cfg, tree, t)
        if module is encdec:
            return encdec.EncDecLM(cfg, {
                **{k: t(tree[k]) for k in ("embed", "pos_enc", "pos_dec", "head")},
                **{k: {n: t(a) for n, a in tree[k].items()} for k in ("enc_ln", "dec_ln")},
                "enc": (_per_layer(tree["enc"], i, t) for i in range(cfg.n_encoder_layers)),
                "dec": (_per_layer(tree["dec"], i, t) for i in range(cfg.n_layers)),
            })
        params = {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
        if not cfg.tie_embeddings:
            params["head"] = t(tree["head"])
        if cfg.family == "vlm":
            n_groups, per_group = transformer.vlm_layout(cfg)
            g = tree["groups"]
            params["layers"] = (_per_layer(_per_layer(g["self"], i, lambda a: a), j, t)
                                for i in range(n_groups) for j in range(per_group))
            params["cross"] = (_per_layer(g["cross"], i, t) for i in range(n_groups))
        else:
            params["layers"] = (_per_layer(tree["layers"], i, t) for i in range(cfg.n_layers))
        return transformer.DecoderLM(cfg, params)


def _xlstm_from_numpy(cfg, tree, t):
    n_groups, n_m = recurrent.xlstm_groups(cfg)
    g = tree["groups"]

    def group(i):
        return {"m": [{"cell": {k: t(a[i, j]) for k, a in g["m"]["cell"].items()},
                       "ln": t(g["m"]["ln"][i, j])} for j in range(n_m)],
                "s": {k: t(a[i]) for k, a in g["s"].items()}, "s_ln": t(g["s_ln"][i])}

    return recurrent.XLSTMLM(cfg, {
        "embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
        "head": t(tree["head"]), "groups": (group(i) for i in range(n_groups)),
    })


def _zamba_from_numpy(cfg, tree, t):
    n_groups, rem = recurrent.zamba_groups(cfg)
    mamba = tree["groups"]["mamba"]
    return recurrent.ZambaLM(cfg, {
        "embed": t(tree["embed"]), "final_norm": t(tree["final_norm"]),
        "head": t(tree["head"]),
        "groups": ((_per_layer(_per_layer(mamba, g, lambda a: a), j, t)
                    for j in range(cfg.attn_every)) for g in range(n_groups)),
        "tail": (_per_layer(tree["tail"], j, t) for j in range(rem)),
        "shared": _map_tree(tree["shared"], t),
    })


def _with_masters(build) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    with recording_sources() as sources:
        model = build()
    masters = {}
    for name, p in model.named_parameters():
        src = sources[p]
        master = src.to(torch.float32)
        # a float32 weight is its source's storage: the master gets its own
        masters[name] = master.clone() if master.data_ptr() == p.data_ptr() else master
        p.requires_grad_(True)
    return model, masters


def init_trainable(cfg, seed: Optional[int] = 0, device="cuda", max_seq: int = 4096):
    """(model, masters): :func:`init_params`' model with every parameter
    requiring grad, and {parameter name: its float32 value before the cast
    to the module's type}; with ``seed=None``, both on ``meta``."""
    return _with_masters(lambda: init_params(cfg, seed, device, max_seq))


def trainable_from_numpy(cfg, tree: Mapping[str, Any], device="cuda"):
    """(model, masters) as :func:`init_trainable` gives them, from
    ``repro``'s float32 parameter tree (:func:`params_from_numpy`)."""
    return _with_masters(lambda: params_from_numpy(cfg, tree, device))


@torch.no_grad()
def load_masters(model: torch.nn.Module, masters: Mapping[str, Any]) -> None:
    """Cast each master (a tensor or a numpy array) into the module's
    parameter of that name, in its type and on its device."""
    for name, p in model.named_parameters():
        p.copy_(torch.as_tensor(masters[name]))


def loss(cfg, model, batch: Dict[str, torch.Tensor], remat: bool = True,
         kernels: Kernels = PLAIN) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens", "labels"} [B, S] (vlm: and "vision"; encdec: and
    "audio", of :func:`extra_inputs`' shapes) → (loss, ce), 0-d float32
    tensors with the module's parameters in their graph. A model sharded
    over a mesh runs through ``sharding.sharded(kernels, rules)``, whose
    ``constrain`` is ``repro``'s layout at its sites (the same for
    :func:`prefill` and :func:`decode_step`)."""
    tokens, labels = batch["tokens"], batch["labels"]
    if cfg.family == "hybrid":
        return recurrent.zamba_loss(cfg, model, tokens, labels, remat, kernels)
    if cfg.family == "ssm":
        return recurrent.xlstm_loss(cfg, model, tokens, labels, remat, kernels)
    if cfg.family == "encdec":
        return encdec.encdec_loss(cfg, model, tokens, labels, batch["audio"], remat, kernels)
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.lm_loss(cfg, model, tokens, labels, batch.get("vision"), remat,
                                   kernels)
    raise ValueError(f"unknown model family {cfg.family!r}")


def prefill(cfg, params, batch: Dict[str, torch.Tensor], max_seq: int,
            kernels: Kernels = KERNELS):
    """batch {"tokens": [B, S]} (vlm: and "vision"; encdec: and "audio", of
    :func:`extra_inputs`' shapes) → (logits [B, 1, V], cache)."""
    module = _module(cfg)
    with torch.no_grad():
        if cfg.family == "hybrid":
            return recurrent.zamba_prefill(cfg, params, batch["tokens"], max_seq, kernels)
        if module is recurrent:
            return recurrent.xlstm_prefill(cfg, params, batch["tokens"], max_seq, kernels)
        if module is encdec:
            return encdec.encdec_prefill(cfg, params, batch["tokens"], batch["audio"],
                                         max_seq, kernels)
        return transformer.lm_prefill(cfg, params, batch["tokens"], max_seq, kernels,
                                      vision=batch.get("vision"))


def decode_step(cfg, params, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at ``pos`` (an int, or a 0-d int64 tensor on the token's
    device) → (logits [B, 1, V], cache updated in place). No shape depends
    on ``pos`` and nothing reads it on the host, so a CUDA graph can replay
    the step."""
    module = _module(cfg)
    with torch.no_grad():
        if cfg.family == "hybrid":
            return recurrent.zamba_decode_step(cfg, params, cache, token, pos, kernels)
        if module is recurrent:
            return recurrent.xlstm_decode_step(cfg, params, cache, token, pos, kernels)
        if module is encdec:
            return encdec.encdec_decode_step(cfg, params, cache, token, pos, kernels)
        return transformer.lm_decode_step(cfg, params, cache, token, pos, kernels)


def cache_shape(cfg, batch: int, max_seq: int):
    """{leaf: (shape, dtype)} of the decode cache, nested as ``repro``
    nests it (a hybrid config without a tail has ``"tail": None``)."""
    module = _module(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_cache_shape(cfg, batch, max_seq)
    if module is recurrent:
        return recurrent.xlstm_cache_shape(cfg, batch, max_seq)
    if module is encdec:
        return encdec.encdec_cache_shape(cfg, batch, max_seq)
    return transformer.lm_cache_shape(cfg, batch, max_seq)


# -- logical axes (models/sharding.py) -----------------------------------------
# The port's own tables of ``repro``'s annotations (``init_*`` of each family,
# ``*_cache_shape``). A parameter's table drops the leading "layers" axes of
# ``repro``'s stacked leaves, which map to no mesh axis, since the port keeps
# one parameter per layer; a cache leaf keeps them, as the port's cache is
# stacked too. Keys are the port's parameter names with each index a "#".

_ATTN = {"wq": ("d_in", "feat"), "wk": ("d_in", "feat"), "wv": ("d_in", "feat"),
         "wo": ("feat", "d_in"), "bq": ("feat",), "bk": ("feat",), "bv": ("feat",),
         "q_norm": ("none",), "k_norm": ("none",)}
_SWIGLU = {"w1": ("d_in", "feat"), "w3": ("d_in", "feat"), "w2": ("feat", "d_in")}
_GELU = {"w1": ("d_in", "feat"), "b1": ("feat",), "w2": ("feat", "d_in"), "b2": ("none",)}
_MOE = {"router": ("d_in", "none"), "w1": ("experts", "d_in", None),
        "w3": ("experts", "d_in", None), "w2": ("experts", None, "d_in")}
_MLSTM = {"wq": ("d_in", "feat"), "wk": ("d_in", "feat"), "wv": ("d_in", "feat"),
          "wi": ("d_in", "none"), "wf": ("d_in", "none"), "wo_gate": ("d_in", "feat"),
          "out_proj": ("feat", "d_in")}
_SLSTM = {"w_in": ("d_in", None), "r": ("none", "none", "none"), "b": ("none",),
          "out_proj": ("d_in", "feat"), "ff_w1": ("d_in", "feat"), "ff_w3": ("d_in", "feat"),
          "ff_w2": ("feat", "d_in")}
_MAMBA = {"in_proj": ("d_in", "feat"), "conv_w": ("none", "feat"), "dt_bias": ("none",),
          "A_log": ("none",), "D": ("none",), "out_proj": ("feat", "d_in")}
_NORM = ("none",)
_LN = {"w": _NORM, "b": _NORM}


def _under(prefix: str, table: Mapping[str, tuple]) -> Dict[str, tuple]:
    return {f"{prefix}.{k}": v for k, v in table.items()}


def _logical_table(cfg) -> Dict[str, tuple]:
    top = {"embed": ("vocab", "d_in"), "head": ("d_in", "vocab"), "final_norm": _NORM}
    if cfg.family in ("dense", "moe", "vlm"):
        return {**top, "layers.#.ln1": _NORM, "layers.#.ln2": _NORM,
                **_under("layers.#.attn", _ATTN),
                **_under("layers.#.mlp", _MOE if cfg.family == "moe" else _SWIGLU),
                "cross.#.ln": _NORM, "cross.#.gate": _NORM, **_under("cross.#.attn", _ATTN)}
    if cfg.family == "encdec":
        out = {**top, "pos_enc": ("none", "d_in"), "pos_dec": ("none", "d_in"),
               **_under("enc_ln", _LN), **_under("dec_ln", _LN),
               **_under("enc.#.attn", _ATTN), **_under("enc.#.mlp", _GELU),
               **_under("dec.#.self_attn", _ATTN), **_under("dec.#.cross", _ATTN),
               **_under("dec.#.mlp", _GELU)}
        for ln in ("enc.#.ln1", "enc.#.ln2", "dec.#.ln1", "dec.#.ln2", "dec.#.lnc"):
            out.update(_under(ln, _LN))
        return out
    if cfg.family == "ssm":
        return {**top, **_under("groups.#.m.#.cell", _MLSTM), "groups.#.m.#.ln": _NORM,
                **_under("groups.#.s", _SLSTM), "groups.#.s_ln": _NORM}
    if cfg.family == "hybrid":
        return {**top, **_under("groups.#.#.cell", _MAMBA), "groups.#.#.ln": _NORM,
                **_under("tail.#.cell", _MAMBA), "tail.#.ln": _NORM,
                **_under("shared.attn", _ATTN), **_under("shared.mlp", _SWIGLU),
                "shared.ln": _NORM, "shared.mlp_ln": _NORM}
    raise ValueError(f"unknown model family {cfg.family!r}")


def param_logical(cfg, model: Optional[torch.nn.Module] = None) -> Dict[str, tuple]:
    """{parameter name: its logical axes} for every parameter of ``model``
    (built without numbers on ``meta`` when None), ``repro``'s annotation
    of the same weight without its stacked "layers" axes."""
    if model is None:
        model = init_params(cfg, None, "meta", max_seq=8)
    table = _logical_table(cfg)
    out = {}
    for name, p in model.named_parameters():
        logical = table[re.sub(r"\.\d+(?=\.|$)", ".#", name)]
        if len(logical) != p.dim():
            raise ValueError(f"{name}: {p.dim()} dims, logical axes {logical}")
        out[name] = logical
    return out


def cache_logical(cfg, batch: int, max_seq: int):
    """The logical axes of each :func:`cache_shape` leaf, nested as it is
    (``repro``'s ``cache_shape(...)[1]``; a hybrid config without a tail
    has ``"tail": None``). ``batch`` and ``max_seq`` do not enter."""
    del batch, max_seq
    module = _module(cfg)
    if cfg.family == "hybrid":
        return recurrent.zamba_cache_logical(cfg)
    if module is recurrent:
        return recurrent.xlstm_cache_logical()
    if module is encdec:
        return encdec.encdec_cache_logical()
    return transformer.lm_cache_logical(cfg)
