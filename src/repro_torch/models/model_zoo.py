"""Model API of the port over every architecture of the JAX package:
``make_model(cfg)`` returns a :class:`Model` with init / loss / prefill /
decode entry points bound to one device.  The audio family (whisper)
runs :mod:`repro_torch.models.whisper`, every other family the decoder
of :mod:`repro_torch.models.transformer`.

The device defaults to CUDA; without a card, and without
``device="cpu"``, :func:`make_model` raises.  A ``mesh``
(``launch.mesh.Mesh``) binds the model to its ranks: an MoE layer runs
over the mesh's model axis; attention (whisper's cross-attention too),
the dense and GELU MLPs, the embedding and the head, the RG-LRU and the
xLSTM blocks are tensor-parallel over it wherever it divides their
heads, widths or vocab (``transformer.tp_split``); and ``init_params``
keeps this rank's slice of each leaf (``Model.specs``,
``transformer.storage_specs``).  ``fsdp=True`` also shards the big
leaves over ``data`` (the reference's FSDP rule), gathered at use;
``cfg.seq_shard`` keeps the residual split over the model axis along
the sequence.  The logits of ``prefill`` and ``decode_step`` are this
rank's vocab columns where the vocab is split (the serving engine
gathers them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whs


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable    # (generator) -> params
    loss: Callable           # (params, batch) -> (loss, metrics)
    prefill: Callable        # (params, batch, cache_capacity) -> (logits, cache)
    decode_step: Callable    # (params, tokens, cache) -> (logits, cache)
    init_cache: Callable     # (params, batch, batch_size, seq) -> cache
    mesh: object = None      # launch.mesh.Mesh, or None: one rank
    fsdp: bool = False
    specs: dict = None       # path -> storage spec of every leaf on mesh


def make_model(cfg: ModelConfig, device=None, mesh=None,
               fsdp: bool = False) -> Model:
    dev = resolve_device(device)
    specs = None if mesh is None else tfm.param_specs(cfg, mesh, fsdp=fsdp)
    # the specs the forward gathers FSDP shards by
    used = specs if fsdp and mesh is not None else None
    kw = dict(mesh=mesh, specs=used)
    if cfg.family == "audio":
        def init_params(generator: torch.Generator):
            return whs.init_whisper(cfg, generator=generator, device=dev,
                                    mesh=mesh, fsdp=fsdp)

        def loss(params, batch):
            return whs.whisper_loss(params, batch, cfg, **kw)

        def prefill(params, batch, cache_capacity=None):
            logits, cache, _ = whs.whisper_forward(
                params, batch["tokens"], batch["frames"], cfg,
                mode="prefill", cache_capacity=cache_capacity, **kw)
            return logits, cache

        def decode_step(params, tokens, cache):
            logits, cache, _ = whs.whisper_forward(
                params, tokens, None, cfg, mode="decode", cache=cache, **kw)
            return logits, cache

        def init_cache(params, batch, batch_size, seq):
            return whs.whisper_init_cache(params, batch["frames"], cfg,
                                          batch_size, seq, **kw)
    else:
        def init_params(generator: torch.Generator):
            return tfm.init_decoder(cfg, generator=generator, device=dev,
                                    mesh=mesh, fsdp=fsdp)

        def loss(params, batch):
            return tfm.lm_loss(params, batch, cfg, **kw)

        def prefill(params, batch, cache_capacity=None):
            logits, cache, _ = tfm.decoder_forward(
                params, batch["tokens"], cfg, mode="prefill",
                patch_embeds=batch.get("patch_embeds"),
                cache_capacity=cache_capacity, **kw)
            return logits, cache

        def decode_step(params, tokens, cache):
            logits, cache, _ = tfm.decoder_forward(params, tokens, cfg,
                                                   mode="decode", cache=cache,
                                                   **kw)
            return logits, cache

        def init_cache(params, batch, batch_size, seq):
            return tfm.init_cache(cfg, batch_size, seq, device=dev,
                                  mesh=mesh)

    return Model(cfg=cfg, device=dev, init_params=init_params, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache, mesh=mesh, fsdp=fsdp,
                 specs=specs)


def with_kernel_config(model: Model, kernel_config) -> Model:
    """Rebuild a :class:`Model` over ``kernel_config`` (the tile shapes of
    every grouped GEMM).  Params are untouched, so one param tree serves
    several phase-specialized models.  No-op when the config matches."""
    if model.cfg.kernel_config == kernel_config:
        return model
    return make_model(dataclasses.replace(model.cfg,
                                          kernel_config=kernel_config),
                      model.device, model.mesh, model.fsdp)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 batch_size: Optional[int] = None, *,
                 decode: bool = False) -> dict:
    """Empty tensors of one step's data inputs, the JAX package's
    ``batch_struct``: tokens (and, unless ``decode``, labels) [B, S], and
    the stub frontends' bf16 ``frames`` / ``patch_embeds`` as
    :func:`synthetic_batch` draws them.  Tokens take the port's int64
    (the reference's are int32), as :func:`synthetic_batch`'s do.  Meant
    to be made under the dry run's ``FakeTensorMode``, where they hold no
    data; on the CPU."""
    b = batch_size or shape.global_batch
    s = 1 if decode else shape.seq_len

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="cpu")
    d = {"tokens": empty((b, s), torch.int64)}
    if not decode:
        d["labels"] = empty((b, s), torch.int64)
    if cfg.family == "audio" and not decode:
        d["frames"] = empty((b, cfg.encoder_seq, cfg.d_model),
                            torch.bfloat16)
    if cfg.family == "vlm" and not decode:
        d["patch_embeds"] = empty((b, cfg.num_patches, cfg.patch_embed_dim),
                                  torch.bfloat16)
    return d


def synthetic_batch(generator: torch.Generator, cfg: ModelConfig,
                    seq_len: int, batch_size: int, *, device=None):
    """Random batch drawn from ``generator`` (on its device unless
    ``device`` is given): tokens (the labels too), and the stub frontends'
    inputs, bf16 normal draws: ``frames`` [B, encoder_seq, d_model] for
    the audio family, ``patch_embeds`` [B, num_patches, patch_embed_dim]
    for a VLM."""
    dev = device if device is not None else generator.device
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=dev, dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = normal(batch_size, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        batch["patch_embeds"] = normal(batch_size, cfg.num_patches,
                                       cfg.patch_embed_dim)
    return batch
