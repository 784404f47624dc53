"""Whisper-style encoder-decoder backbone (``repro/models/encdec.py``).

The conv frontend is a stub, as in ``repro``: the encoder takes precomputed
frame embeddings [B, n_audio_frames, d]. Encoder layers: learned positions,
LayerNorm, non-causal self-attention without RoPE, GELU MLP, then a final
LayerNorm. Decoder layers: learned positions (``pos_dec``, ``max_seq`` rows,
sized at init), causal self-attention (with RoPE, as ``repro``'s default
has it), cross-attention to the encoder output, GELU MLP, a final LayerNorm
and an untied head. LayerNorm is plain tensor code in both packages; every
prefill attention (encoder, decoder self and cross) goes through the flash
kernel.

Cache: ``k`` / ``v`` ``[L, B, S_max, KV, hd]``, updated in place by each
decode step, and ``cross_k`` / ``cross_v`` ``[L, B, n_audio_frames, KV,
hd]``, the decoder layers' projections of the encoder output, filled at
prefill and only read by decode. A decode step reads ``pos_dec`` at a
device-tensor position (``index_select``), so a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from .attention import Attention, init_attention
from .common import (COMPUTE_DTYPE, KERNELS, PARAM_DTYPE, PLAIN, Kernels, dense_init,
                     frozen, layernorm, ones_init, position, run_layer, zeros_init)
from .mlp import GeluMLP, init_gelu_mlp
from .sharding import CROSS_CACHE, KV_CACHE

__all__ = ["EncDecLM", "init_encdec", "encode", "encdec_forward", "encdec_loss",
           "encdec_prefill", "encdec_decode_step", "encdec_cache_shape"]


def _init_ln(gen, d) -> dict:
    return {"w": ones_init(gen, (d,)), "b": zeros_init(gen, (d,))}


class LayerNorm(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.eps = cfg.norm_eps
        self.w = frozen(p["w"], PARAM_DTYPE)
        self.b = frozen(p["b"], PARAM_DTYPE)

    def forward(self, x):
        return layernorm(x, self.w, self.b, self.eps)


class EncoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.ln1, self.ln2 = LayerNorm(cfg, p["ln1"]), LayerNorm(cfg, p["ln2"])
        self.attn = Attention(cfg, p["attn"])
        self.mlp = GeluMLP(p["mlp"])

    def forward(self, x, kernels: Kernels = KERNELS):
        c = kernels.constrain
        a, _ = self.attn(self.ln1(x), None, kernels, causal=False, rope=False)
        x = c(x + a)
        return c(x + self.mlp(self.ln2(x), kernels))


class DecoderLayer(nn.Module):
    def __init__(self, cfg, p: Mapping):
        super().__init__()
        self.ln1, self.lnc = LayerNorm(cfg, p["ln1"]), LayerNorm(cfg, p["lnc"])
        self.ln2 = LayerNorm(cfg, p["ln2"])
        self.self_attn = Attention(cfg, p["self"])
        self.cross = Attention(cfg, p["cross"], cross=True)
        self.mlp = GeluMLP(p["mlp"])

    def forward(self, x, enc_out, positions, kernels: Kernels = KERNELS):
        c = kernels.constrain
        a, skv = self.self_attn(self.ln1(x), positions, kernels)
        x = c(x + a)
        a, ckv = self.cross(self.lnc(x), None, kernels, causal=False, kv_x=enc_out, rope=False)
        x = c(x + a)
        return c(x + self.mlp(self.ln2(x), kernels)), skv, ckv

    def decode(self, x, cache_k, cache_v, cross_k, cross_v, pos, kernels: Kernels = KERNELS):
        c = kernels.constrain
        x = c(x + self.self_attn.decode(self.ln1(x), cache_k, cache_v, pos, kernels))
        x = c(x + self.cross.decode_cross(self.lnc(x), cross_k, cross_v, kernels))
        return c(x + self.mlp(self.ln2(x), kernels))


class EncDecLM(nn.Module):
    """``params`` is the reference's tree with one dict per layer: {"embed",
    "pos_enc", "pos_dec", "head", "enc": [{"attn", "mlp", "ln1", "ln2"}],
    "dec": [{"self", "cross", "mlp", "ln1", "lnc", "ln2"}], "enc_ln",
    "dec_ln"}."""

    def __init__(self, cfg, params: Mapping):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"not an encoder-decoder family: {cfg.family}")
        self.cfg = cfg
        for name in ("embed", "pos_enc", "pos_dec", "head"):
            setattr(self, name, frozen(params[name], COMPUTE_DTYPE))
        self.enc = nn.ModuleList(EncoderLayer(cfg, p) for p in params["enc"])
        self.dec = nn.ModuleList(DecoderLayer(cfg, p) for p in params["dec"])
        self.enc_ln = LayerNorm(cfg, params["enc_ln"])
        self.dec_ln = LayerNorm(cfg, params["dec_ln"])


def init_encdec(cfg, gen: torch.Generator, max_seq: int = 4096) -> EncDecLM:
    """Random parameters from ``gen``, layer by layer on its device;
    ``pos_dec`` has ``max_seq`` rows, as ``repro``'s ``init_encdec``
    makes it."""
    d = cfg.d_model

    def enc():
        for _ in range(cfg.n_encoder_layers):
            yield {"attn": init_attention(cfg, gen), "mlp": init_gelu_mlp(cfg, gen),
                   "ln1": _init_ln(gen, d), "ln2": _init_ln(gen, d)}

    def dec():
        for _ in range(cfg.n_layers):
            yield {"self": init_attention(cfg, gen), "cross": init_attention(cfg, gen, cross=True),
                   "mlp": init_gelu_mlp(cfg, gen), "ln1": _init_ln(gen, d),
                   "lnc": _init_ln(gen, d), "ln2": _init_ln(gen, d)}

    return EncDecLM(cfg, {
        "embed": dense_init(gen, (cfg.vocab, d)), "pos_enc": dense_init(gen, (cfg.n_audio_frames, d)),
        "pos_dec": dense_init(gen, (max_seq, d)), "head": dense_init(gen, (d, cfg.vocab)),
        "enc": enc(), "dec": dec(), "enc_ln": _init_ln(gen, d), "dec_ln": _init_ln(gen, d),
    })


def encode(cfg, model: EncDecLM, audio, kernels: Kernels = KERNELS,
           remat: bool = False) -> torch.Tensor:
    """audio [B, F, d] → encoder output [B, F, d] bf16; with ``remat``
    each layer keeps only its input for the backward."""
    f = audio.shape[1]
    x = kernels.constrain(audio.to(COMPUTE_DTYPE) + model.pos_enc[:f])
    for layer in model.enc:
        x = run_layer(layer, x, kernels, remat=remat)
    return model.enc_ln(x)


def _decoder(cfg, model: EncDecLM, tokens, audio, kernels: Kernels, cache=None):
    """Encoder, then the decoder layers: hidden [B, S, d] before ``dec_ln``.
    With ``cache``, layer i's self k / v go to ``cache["k"][i, :, :S]`` /
    ``cache["v"][i, :, :S]`` and its cross k / v to ``cache["cross_k"][i]``
    / ``cache["cross_v"][i]``."""
    enc_out = encode(cfg, model, audio, kernels)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = kernels.constrain(kernels.embed(model.embed, tokens) + model.pos_dec[:s])
    for i, layer in enumerate(model.dec):
        x, (k, v), (ck, cv) = layer(x, enc_out, positions, kernels)
        if cache is not None:
            kernels.write_prefix(cache["k"], i, k)
            kernels.write_prefix(cache["v"], i, v)
            kernels.write_prefix(cache["cross_k"], i, ck)
            kernels.write_prefix(cache["cross_v"], i, cv)
    return x


def encdec_forward(cfg, model: EncDecLM, tokens, audio, kernels: Kernels = KERNELS):
    """tokens [B, S], audio [B, F, d] → logits [B, S, V]."""
    return kernels.matmul(model.dec_ln(_decoder(cfg, model, tokens, audio, kernels)),
                          model.head)


def _decoder_hidden(layer, x, enc_out, positions, kernels):
    return layer(x, enc_out, positions, kernels)[0]


def encdec_loss(cfg, model: EncDecLM, tokens, labels, audio, remat: bool = True,
                kernels: Kernels = PLAIN):
    """(ce, ce), ``repro``'s ``encdec_loss``: with ``remat`` every encoder
    and decoder layer keeps only its inputs for the backward, as ``repro``
    checkpoints both scan bodies."""
    enc_out = encode(cfg, model, audio, kernels, remat=remat)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = kernels.constrain(kernels.embed(model.embed, tokens) + model.pos_dec[:s])
    for layer in model.dec:
        x = run_layer(_decoder_hidden, layer, x, enc_out, positions, kernels, remat=remat)
    ce = kernels.cross_entropy(kernels.matmul(model.dec_ln(x), model.head), labels)
    return ce, ce


def encdec_cache_shape(cfg, batch: int, max_seq: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
    cross = ((cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd), COMPUTE_DTYPE)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}


def encdec_cache_logical():
    """The logical axes of each :func:`encdec_cache_shape` leaf."""
    return {"k": KV_CACHE, "v": KV_CACHE, "cross_k": CROSS_CACHE, "cross_v": CROSS_CACHE}


def encdec_prefill(cfg, model: EncDecLM, tokens, audio, max_seq: int,
                   kernels: Kernels = KERNELS):
    """Returns (logits of the last position [B, 1, V], cache), the self
    cache padded with zeros to ``max_seq``."""
    cache = kernels.new_cache(encdec_cache_shape(cfg, tokens.shape[0], max_seq), tokens,
                              encdec_cache_logical())
    x = _decoder(cfg, model, tokens, audio, kernels, cache)
    return kernels.matmul(model.dec_ln(x[:, -1:]), model.head), cache


def encdec_decode_step(cfg, model: EncDecLM, cache, token, pos, kernels: Kernels = KERNELS):
    """token [B, 1] at ``pos`` (an int or a 0-d int64 tensor on the token's
    device) → (logits [B, 1, V], cache), the self cache updated in place."""
    pos = position(pos, token.device)
    x = kernels.constrain(kernels.embed(model.embed, token)
                          + model.pos_dec.index_select(0, pos.view(1)))
    for i, layer in enumerate(model.dec):
        x = layer.decode(x, cache["k"][i], cache["v"][i], cache["cross_k"][i],
                         cache["cross_v"][i], pos, kernels)
    return kernels.matmul(model.dec_ln(x), model.head), cache
