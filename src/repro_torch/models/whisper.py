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

On a mesh (the reference's rules, which name the attention and MLP
leaves as the attention families do): self- and cross-attention split
their heads over the model axis where it divides them, the GELU MLP its
``d_ff``, and the embedding and head their vocab (whisper-tiny's 51865
stays whole); each layer's cross K/V are cached by head.  The encoder
output, which every decoder layer's cross-attention reads, is whole on
every rank.  ``cfg.seq_shard`` splits the encoder's and the decoder's
residuals over the model axis along the sequence, where the reference
places them (its ``whisper.py`` lines 83 and 109), as
:mod:`repro_torch.models.transformer` does; the encoder output is
gathered back.  ``specs`` (FSDP) gathers each layer's shards at use,
inside the remat scope.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import shard_tree, use_tree
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, embed, init_embedding,
                                       init_mlp, init_rms_norm, mlp, norm,
                                       remat_scope, rms_norm, row_parallel,
                                       sublayer, tp_in, unembed)
from repro_torch.models.transformer import param_specs, seq_parallel, \
    tp_split


class _Place:
    """Where a forward runs on the mesh: the model axis's ``group`` (None
    on one rank), what it splits (``transformer.tp_split``) and whether
    the residual is sequence-parallel (``sp``)."""

    def __init__(self, cfg: ModelConfig, mesh, s: int = 0):
        self.split = tp_split(cfg, dctx.model_axis_size(mesh))
        if self.split.get("heads") and not self.split["kv"]:
            raise ValueError(f"{cfg.name}: the cross-attention splits its "
                             f"kv heads with its q heads; "
                             f"{cfg.num_kv_heads} kv heads do not divide "
                             f"the model axis")
        self.group = mesh.group("model") if self.split else None
        self.sp = bool(s) and seq_parallel(cfg, mesh, s)
        self.ngroup = self.group if self.sp else None

    def heads(self):
        return self.group if self.split.get("heads") else None

    def vocab(self):
        return self.group if self.split.get("vocab") else None


def _mlp(lp, h, cfg: ModelConfig, pl: _Place):
    return sublayer(lambda h, g, seq: (mlp(
        lp["mlp"], h, "gelu", precision=cfg.precision,
        config=cfg.resolved_kernel_config, group=g, seq=seq), None),
        h, pl.group, pl.split.get("mlp", False), pl.sp)[0]


def _cross_attention(p, x, enc_kv, cfg: ModelConfig, group=None,
                     seq: bool = False):
    """x: [B, S, d] queries; enc_kv: (k, v) [B, Se, Hkv, hd] precomputed
    (this rank's kv heads under ``group``, whose ranks run their q
    heads).  No RoPE, as in the JAX package."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = dctx.group_size(group) > 1
    if tp:
        x = tp_in(x, group, seq)
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, hd)
    k, v = enc_kv
    out = attn.chunked_attention(q, k, v, causal=False, window=None,
                                 chunk=cfg.attn_chunk, k_valid=k.shape[1])
    out = out.reshape(b, s, -1)
    if tp:
        return row_parallel(out, p["wo"], group, seq)
    return out @ p["wo"].to(x.dtype)


def _enc_kv(p, enc_out, cfg: ModelConfig, group=None):
    """Cross K/V of ``enc_out`` (whole on every rank): this rank's kv
    heads under ``group``."""
    b, se, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    if dctx.group_size(group) > 1:
        enc_out = dctx.copy_to(enc_out, group)
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, se, -1, hd)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, se, -1, hd)
    return k, v


def init_whisper(cfg: ModelConfig, *, generator: torch.Generator, device,
                 mesh=None, fsdp: bool = False):
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

    specs = None if mesh is None else param_specs(cfg, mesh, fsdp=fsdp)

    def keep(tree, prefix):
        return tree if specs is None else shard_tree(tree, specs, mesh,
                                                     prefix)
    return {
        "embed": keep(init_embedding(cfg.vocab_size, d, dt, False, **kw),
                      "embed/"),
        "final_norm": init_rms_norm(d, device=device),
        "enc_final_norm": init_rms_norm(d, device=device),
        "enc_layers": [keep(enc_layer(), f"enc_layers/{i}/")
                       for i in range(cfg.encoder_layers)],
        "layers": [keep(dec_layer(), f"layers/{i}/")
                   for i in range(cfg.num_layers)],
    }


def _used(tree, prefix, specs, mesh):
    return tree if specs is None else use_tree(tree, specs, mesh, prefix)


def whisper_encode(params, frames, cfg: ModelConfig, mesh=None,
                   specs: Optional[dict] = None):
    """frames: [B, Se, d_model] precomputed embeddings (stub frontend).
    The output is whole on every rank of a mesh."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    pl = _Place(cfg, mesh, x.shape[1])
    if pl.sp:
        x = dctx.split_seq(x, pl.group)

    def layer(i, x):
        lp = _used(params["enc_layers"][i], f"enc_layers/{i}/", specs, mesh)
        h, _ = sublayer(
            lambda h, g, seq: attn.attention_block(
                lp["attn"], h, cfg, positions, causal=False, group=g,
                seq=seq),
            norm(lp["ln1"], x, cfg.norm_eps, pl.ngroup), pl.group,
            pl.split.get("heads", False), pl.sp)
        x = x + h
        return x + _mlp(lp, norm(lp["ln2"], x, cfg.norm_eps, pl.ngroup), cfg,
                        pl)
    if cfg.remat and torch.is_grad_enabled():
        layer = remat_scope(layer)
    for i in range(len(params["enc_layers"])):
        x = layer(i, x)
    if pl.sp:
        x = dctx.gather_seq(x, pl.group, grad="own")
    return rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def whisper_forward(params, tokens, frames, cfg: ModelConfig, *,
                    mode="train", cache=None,
                    cache_capacity: Optional[int] = None, mesh=None,
                    specs: Optional[dict] = None):
    """Returns (logits, new_cache, aux).  The cache carries each layer's
    self-attention K/V, its cross K/V and the encoder output, so decode
    steps run the decoder alone.  On a mesh the logits are this rank's
    vocab columns where the vocab is split."""
    enc_out = (cache["enc_out"] if cache is not None and "enc_out" in cache
               else whisper_encode(params, frames, cfg, mesh, specs))
    pl = _Place(cfg, mesh, tokens.shape[1])
    x = embed(_used(params["embed"], "embed/", specs, mesh), tokens,
              pl.vocab())
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    if pl.sp:
        x = dctx.split_seq(x, pl.group)
    layers = []

    def layer(li, lc, x, enc_out):
        lp = _used(params["layers"][li], f"layers/{li}/", specs, mesh)
        h, nc = sublayer(
            lambda h, g, seq: attn.attention_block(
                lp["attn"], h, cfg, positions,
                cache=lc["self"] if lc is not None else None, mode=mode,
                cache_capacity=cache_capacity, group=g, kv_split=True,
                seq=seq),
            norm(lp["ln1"], x, cfg.norm_eps, pl.ngroup), pl.group,
            pl.split.get("heads", False), pl.sp)
        x = x + h

        def cross(h, g, seq):
            xk = (lc["xkv"] if lc is not None and "xkv" in lc
                  else _enc_kv(lp["xattn"], enc_out, cfg, g))
            return _cross_attention(lp["xattn"], h, xk, cfg, g, seq), xk
        h, xk = sublayer(cross, norm(lp["ln2"], x, cfg.norm_eps, pl.ngroup),
                         pl.group, pl.split.get("heads", False), pl.sp)
        x = x + h
        x = x + _mlp(lp, norm(lp["ln3"], x, cfg.norm_eps, pl.ngroup), cfg, pl)
        if mode != "train":
            layers.append({"self": nc, "xkv": xk})
        return x
    if cfg.remat and mode == "train" and torch.is_grad_enabled():
        layer = remat_scope(layer)
    for li in range(len(params["layers"])):
        x = layer(li, cache["layers"][li] if cache is not None else None,
                  x, enc_out)
    if pl.sp:
        x = dctx.gather_seq(x, pl.group, grad="own")
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"layers": layers, "enc_out": enc_out}
    if mode == "prefill":
        x = x[:, -1:]        # serving prefill needs only the last position
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (unembed(_used(params["embed"], "embed/", specs, mesh), x,
                    pl.vocab()), new_cache, aux)


def whisper_init_cache(params, frames, cfg: ModelConfig, batch: int,
                       seq_len: int, mesh=None, specs: Optional[dict] = None):
    """Decode cache: the encoder output, and each layer's empty
    self-attention K/V (split over its slots where the heads are split)
    and its cross K/V (this rank's heads)."""
    pl = _Place(cfg, mesh)
    enc_out = whisper_encode(params, frames, cfg, mesh, specs)
    g = pl.heads()
    out = []
    for li in range(len(params["layers"])):
        lp = _used(params["layers"][li], f"layers/{li}/", specs, mesh)
        out.append({"self": attn.init_kv_cache(cfg, batch, seq_len,
                                               device=enc_out.device,
                                               group=g),
                    "xkv": _enc_kv(lp["xattn"], enc_out, cfg, g)})
    return {"layers": out, "enc_out": enc_out}


def whisper_loss(params, batch, cfg: ModelConfig, mesh=None,
                 specs: Optional[dict] = None):
    logits, _, aux = whisper_forward(params, batch["tokens"],
                                     batch["frames"], cfg, mode="train",
                                     mesh=mesh, specs=specs)
    pl = _Place(cfg, mesh)
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:], pl.vocab())
    return loss, {"ce": loss, "aux": aux}
