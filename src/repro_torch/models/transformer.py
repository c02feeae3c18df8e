"""Decoder LM of attention blocks, each with MoE or a dense MLP.

The JAX package scans over stacked layer params; here ``params["layers"]``
is a list of per-layer dicts and the scan is a Python loop.  Modes:
"train" (differentiable: :func:`lm_loss` trains through it), "prefill"
(returns per-layer caches), "decode" (one token against the caches,
updated in place).
Only the ``("attn",)`` block pattern is ported, with MoE in every layer
(``cfg.moe``), or a dense SwiGLU MLP of width ``cfg.d_ff`` in the first
``cfg.moe.first_dense_layers`` and MoE in the rest (the JAX package's
``pre{i}`` blocks, then its stacked layers), or a dense SwiGLU MLP in
every layer (the dense family).  Every GEMM call site takes
``cfg.resolved_kernel_config``, the kernel config with ``gemm_backend``
folded in.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.moe import MoEConfig, init_moe_params, moe_apply
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, embed, init_embedding,
                                       init_mlp, init_rms_norm, mlp,
                                       rms_norm, unembed)


def moe_config(cfg: ModelConfig) -> MoEConfig:
    m = cfg.moe
    return MoEConfig(
        num_experts=m.num_experts, top_k=m.top_k, d_model=cfg.d_model,
        d_ff_expert=m.d_ff_expert, num_shared_experts=m.num_shared_experts,
        norm_topk_prob=m.norm_topk_prob, capacity_factor=m.capacity_factor,
        precision=cfg.precision, kernel_config=cfg.resolved_kernel_config,
        dispatch=cfg.moe_dispatch)


def _check_supported(cfg: ModelConfig) -> None:
    moe = cfg.moe
    moe_ok = moe is not None and (
        (not moe.first_dense_layers and not cfg.d_ff)
        or (0 < moe.first_dense_layers <= cfg.num_layers and cfg.d_ff > 0))
    dense_ok = moe is None and cfg.d_ff > 0
    if tuple(cfg.block_pattern) != ("attn",) or not (moe_ok or dense_ok):
        raise NotImplementedError(
            f"{cfg.name}: only decoders of attention blocks, each with MoE "
            "(the first moe.first_dense_layers with a dense MLP of width "
            "d_ff) or a dense MLP, are ported (other blocks: ROADMAP A9, "
            "A14)")


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether block ``i`` carries ``"moe"`` (else a dense ``"mlp"``)."""
    return cfg.moe is not None and i >= cfg.moe.first_dense_layers


def init_block(cfg: ModelConfig, *, generator, device, moe_layer: bool):
    d = cfg.d_model
    p = {"ln1": init_rms_norm(d, device=device),
         "ln2": init_rms_norm(d, device=device),
         "attn": attn.init_attention(cfg, cfg.dtype, generator=generator,
                                     device=device)}
    if moe_layer:
        p["moe"] = init_moe_params(moe_config(cfg), generator=generator,
                                   device=device, dtype=cfg.dtype)
    else:
        p["mlp"] = init_mlp(d, cfg.d_ff, "swiglu", cfg.dtype,
                            generator=generator, device=device)
    return p


def block_apply(p, x, cfg: ModelConfig, positions, *, cache=None,
                mode: str = "train", cache_capacity=None, pos_offset: int = 0):
    """Returns (x, new_cache, aux_loss)."""
    h, new_cache = attn.attention_block(
        p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg, positions,
        cache=cache, layer_window=cfg.window, mode=mode,
        cache_capacity=cache_capacity, pos_offset=pos_offset)
    x = x + h
    h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
    if "moe" not in p:
        ff = mlp(p["mlp"], h2, "swiglu", precision=cfg.precision,
                 config=cfg.resolved_kernel_config)
        return x + ff, new_cache, torch.zeros((), dtype=torch.float32,
                                              device=x.device)
    b, s, d = h2.shape
    ff, aux = moe_apply(p["moe"], h2.reshape(b * s, d), moe_config(cfg))
    return x + ff.reshape(b, s, d), new_cache, aux["load_balance_loss"]


def init_decoder(cfg: ModelConfig, *, generator: torch.Generator, device):
    _check_supported(cfg)
    return {
        "embed": init_embedding(cfg.vocab_size, cfg.d_model, cfg.dtype,
                                cfg.tie_embeddings, generator=generator,
                                device=device),
        "final_norm": init_rms_norm(cfg.d_model, device=device),
        "layers": [init_block(cfg, generator=generator, device=device,
                              moe_layer=is_moe_layer(cfg, i))
                   for i in range(cfg.num_layers)],
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device):
    _check_supported(cfg)
    return {"layers": [attn.init_kv_cache(cfg, batch, seq_len, cfg.window,
                                          device=device)
                       for _ in range(cfg.num_layers)]}


def decoder_forward(params, tokens, cfg: ModelConfig, *, mode="train",
                    cache=None, pos_offset: int = 0,
                    cache_capacity: Optional[int] = None):
    """tokens: [B, S] int.  Returns (logits, new_cache, aux_loss).

    decode mode: S == 1 and ``cache`` holds the per-layer state.
    """
    _check_supported(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    positions = None
    if mode != "decode":
        positions = pos_offset + torch.arange(s, dtype=torch.int32,
                                              device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    caches = []
    for li, lp in enumerate(params["layers"]):
        c = cache["layers"][li] if cache is not None else None
        x, nc, aux = block_apply(lp, x, cfg, positions, cache=c, mode=mode,
                                 cache_capacity=cache_capacity,
                                 pos_offset=pos_offset)
        aux_total = aux_total + aux
        caches.append(nc)
    new_cache = {"layers": caches} if mode in ("prefill", "decode") else None
    if mode == "prefill":
        x = x[:, -1:]        # serving prefill needs only the last position
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), new_cache, aux_total


def lm_loss(params, batch, cfg: ModelConfig, *, aux_weight=0.01):
    """batch: {tokens [B, S], labels [B, S] (-1 = ignore)}.  Next-token
    cross-entropy plus ``aux_weight`` times the MoE load-balance loss;
    returns ``(loss, {"ce", "aux"})``."""
    logits, _, aux = decoder_forward(params, batch["tokens"], cfg,
                                     mode="train")
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
