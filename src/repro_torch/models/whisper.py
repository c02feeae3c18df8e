"""Whisper-style encoder-decoder transformer backbone, the JAX package's
``models/whisper.py`` in PyTorch.

The conv / mel frontend is a stub: the model consumes precomputed frame
embeddings ``frames`` [B, encoder_seq, d_model].  Encoder: bidirectional
attention and a GELU MLP a layer.  Decoder: causal self-attention,
cross-attention over the encoder output and a GELU MLP a layer.  RoPE
positions in both (the JAX package's substitution).  The decode cache
holds the encoder output, each layer's self-attention K/V (written in
place by a decode step, as in :mod:`repro_torch.models.attention`) and
its cross-attention K/V, computed once at prefill and only read after.

Remat, as in the JAX package: with ``cfg.remat`` each encoder layer runs
under ``torch.utils.checkpoint`` whenever gradients are taken, and each
decoder layer in a training forward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, embed, init_embedding,
                                       init_mlp, init_rms_norm, mlp,
                                       remat_scope, rms_norm, unembed)


def _mlp(lp, x, cfg: ModelConfig):
    return mlp(lp["mlp"], x, "gelu", precision=cfg.precision,
               config=cfg.resolved_kernel_config)


def _cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """x: [B, S, d] queries; enc_kv: (k, v) [B, Se, Hkv, hd] precomputed.
    No RoPE, as in the JAX package."""
    b, s, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, hq, hd)
    k, v = enc_kv
    out = attn.chunked_attention(q, k, v, causal=False, window=None,
                                 chunk=cfg.attn_chunk, k_valid=k.shape[1])
    return out.reshape(b, s, hq * hd) @ p["wo"].to(x.dtype)


def _enc_kv(p, enc_out, cfg: ModelConfig):
    b, se, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, se, hkv, hd)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, se, hkv, hd)
    return k, v


def init_whisper(cfg: ModelConfig, *, generator: torch.Generator, device):
    d, dt = cfg.d_model, cfg.dtype
    kw = dict(generator=generator, device=device)

    def norms(n):
        return {f"ln{i + 1}": init_rms_norm(d, device=device)
                for i in range(n)}

    def enc_layer():
        return {**norms(2), "attn": attn.init_attention(cfg, dt, **kw),
                "mlp": init_mlp(d, cfg.d_ff, "gelu", dt, **kw)}

    def dec_layer():
        return {**norms(3), "attn": attn.init_attention(cfg, dt, **kw),
                "xattn": attn.init_attention(cfg, dt, **kw),
                "mlp": init_mlp(d, cfg.d_ff, "gelu", dt, **kw)}

    return {
        "embed": init_embedding(cfg.vocab_size, d, dt, False, **kw),
        "final_norm": init_rms_norm(d, device=device),
        "enc_final_norm": init_rms_norm(d, device=device),
        "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
        "layers": [dec_layer() for _ in range(cfg.num_layers)],
    }


def whisper_encode(params, frames, cfg: ModelConfig):
    """frames: [B, Se, d_model] precomputed embeddings (stub frontend)."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def layer(lp, x):
        h, _ = attn.attention_block(lp["attn"],
                                    rms_norm(lp["ln1"], x, cfg.norm_eps),
                                    cfg, positions, causal=False)
        x = x + h
        return x + _mlp(lp, rms_norm(lp["ln2"], x, cfg.norm_eps), cfg)
    if cfg.remat and torch.is_grad_enabled():
        layer = remat_scope(layer)
    for lp in params["enc_layers"]:
        x = layer(lp, x)
    return rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def whisper_forward(params, tokens, frames, cfg: ModelConfig, *,
                    mode="train", cache=None,
                    cache_capacity: Optional[int] = None):
    """Returns (logits, new_cache, aux).  The cache carries each layer's
    self-attention K/V, its cross K/V and the encoder output, so decode
    steps run the decoder alone."""
    enc_out = (cache["enc_out"] if cache is not None and "enc_out" in cache
               else whisper_encode(params, frames, cfg))
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    layers = []

    def layer(lp, lc, x, enc_out):
        h, nc = attn.attention_block(
            lp["attn"], rms_norm(lp["ln1"], x, cfg.norm_eps), cfg,
            positions, cache=lc["self"] if lc is not None else None,
            mode=mode, cache_capacity=cache_capacity)
        x = x + h
        xk = (lc["xkv"] if lc is not None and "xkv" in lc
              else _enc_kv(lp["xattn"], enc_out, cfg))
        x = x + _cross_attention(lp["xattn"],
                                 rms_norm(lp["ln2"], x, cfg.norm_eps), xk,
                                 cfg)
        x = x + _mlp(lp, rms_norm(lp["ln3"], x, cfg.norm_eps), cfg)
        if mode != "train":
            layers.append({"self": nc, "xkv": xk})
        return x
    if cfg.remat and mode == "train" and torch.is_grad_enabled():
        layer = remat_scope(layer)
    for li, lp in enumerate(params["layers"]):
        x = layer(lp, cache["layers"][li] if cache is not None else None,
                  x, enc_out)
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"layers": layers, "enc_out": enc_out}
    if mode == "prefill":
        x = x[:, -1:]        # serving prefill needs only the last position
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params["embed"], x), new_cache, aux


def whisper_init_cache(params, frames, cfg: ModelConfig, batch: int,
                       seq_len: int):
    """Decode cache: the encoder output, and each layer's empty
    self-attention K/V and its cross K/V."""
    enc_out = whisper_encode(params, frames, cfg)
    return {"layers": [{"self": attn.init_kv_cache(cfg, batch, seq_len,
                                                   device=enc_out.device),
                        "xkv": _enc_kv(lp["xattn"], enc_out, cfg)}
                       for lp in params["layers"]],
            "enc_out": enc_out}


def whisper_loss(params, batch, cfg: ModelConfig):
    logits, _, aux = whisper_forward(params, batch["tokens"],
                                     batch["frames"], cfg, mode="train")
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss, {"ce": loss, "aux": aux}
