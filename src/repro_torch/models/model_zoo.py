"""Model API of the port: ``make_model(cfg)`` returns a :class:`Model`
with init / loss / prefill / decode entry points bound to one device.

The device defaults to CUDA; without a card, and without
``device="cpu"``, :func:`make_model` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable    # (generator) -> params
    loss: Callable           # (params, batch) -> (loss, metrics)
    prefill: Callable        # (params, batch, cache_capacity) -> (logits, cache)
    decode_step: Callable    # (params, tokens, cache) -> (logits, cache)
    init_cache: Callable     # (batch_size, seq) -> cache


def make_model(cfg: ModelConfig, device=None) -> Model:
    dev = resolve_device(device)
    if not ((cfg.family == "moe" and cfg.moe is not None)
            or (cfg.family == "dense" and cfg.moe is None and cfg.d_ff)):
        raise NotImplementedError(f"{cfg.name}: only the MoE and dense "
                                  "decoder families are ported (ROADMAP A9, "
                                  "A14)")

    def init_params(generator: torch.Generator):
        return tfm.init_decoder(cfg, generator=generator, device=dev)

    def loss(params, batch):
        return tfm.lm_loss(params, batch, cfg)

    def prefill(params, batch, cache_capacity=None):
        logits, cache, _ = tfm.decoder_forward(
            params, batch["tokens"], cfg, mode="prefill",
            cache_capacity=cache_capacity)
        return logits, cache

    def decode_step(params, tokens, cache):
        logits, cache, _ = tfm.decoder_forward(params, tokens, cfg,
                                               mode="decode", cache=cache)
        return logits, cache

    def init_cache(batch_size, seq):
        return tfm.init_cache(cfg, batch_size, seq, device=dev)

    return Model(cfg=cfg, device=dev, init_params=init_params, loss=loss,
                 prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache)


def with_kernel_config(model: Model, kernel_config) -> Model:
    """Rebuild a :class:`Model` over ``kernel_config`` (the tile shapes of
    every grouped GEMM).  Params are untouched, so one param tree serves
    several phase-specialized models.  No-op when the config matches."""
    if model.cfg.kernel_config == kernel_config:
        return model
    return make_model(dataclasses.replace(model.cfg,
                                          kernel_config=kernel_config),
                      model.device)


def synthetic_batch(generator: torch.Generator, cfg: ModelConfig,
                    seq_len: int, batch_size: int, *, device=None):
    """Random token batch drawn from ``generator`` (on its device unless
    ``device`` is given)."""
    dev = device if device is not None else generator.device
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=dev, dtype=torch.int64)
    return {"tokens": tokens}

