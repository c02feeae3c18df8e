"""Batched serving engine: prefill + greedy/temperature decode loop with a
static KV-cache capacity (per-sequence stop with a done mask; finished
rows keep decoding into padding).

``kernel_config`` pins the prefill phase's tile shapes and
``decode_kernel_config`` the decode phase's; each phase runs a model
rebuilt over its config, sharing one param tree.  With no decode config,
decode takes the prefill config (the model's, ``gemm_backend`` folded in)
with 16-row tiles, so the backend and the recipe switches
(``fuse_producer``, ``wgrad_precision``) carry over and only the tile
geometry is decode-specialized, as in the JAX package (which picks the
tile by autotuning, not ported yet).  Under ``"padded_baseline"`` decode
thus pads each group to 16 rows.

The batch passes to the model's prefill whole, so a VLM's
``patch_embeds`` and whisper's ``frames`` reach it; a VLM's cache holds
its patch positions too (``num_patches`` more slots).

The engine runs on CUDA unless ``device="cpu"`` is passed; without a card
it raises.  Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.plan import KernelConfig
from repro_torch.models import model_zoo
from repro_torch.models.model_zoo import Model


#: the decode phase's M tile: a decode step routes batch x top_k rows
DECODE_BLOCK_M = 16


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # [B, max_new]
    num_generated: torch.Tensor   # [B]


class Engine:
    def __init__(self, model: Model, params, *, max_new_tokens: int = 32,
                 eos_id: int = -1, temperature: float = 0.0,
                 kernel_config: Optional[KernelConfig] = None,
                 decode_kernel_config: Optional[KernelConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model runs on {model.device}, the engine "
                             f"on {self.device}")
        leaf = params["final_norm"]["scale"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine runs "
                             f"on {self.device}")
        if kernel_config is not None:
            model = model_zoo.with_kernel_config(model, kernel_config)
        self.model = model
        self.prefill_config = model.cfg.resolved_kernel_config
        self.decode_config = (
            decode_kernel_config if decode_kernel_config is not None
            else (self.prefill_config or KernelConfig()).with_(
                block_m=DECODE_BLOCK_M))
        self._decode_model = model_zoo.with_kernel_config(model,
                                                          self.decode_config)
        self.params = params
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature

    def _sample(self, logits, generator):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def prefill(self, batch, cache_capacity: int):
        """Last-position logits [B, V] and the caches of the prompt."""
        logits, cache = self.model.prefill(self.params, batch,
                                           cache_capacity=cache_capacity)
        return logits[:, -1], cache

    def decode_step(self, tokens, cache):
        """One token per row [B] against the caches -> (logits [B, V],
        caches); the caches are updated in place."""
        logits, cache = self._decode_model.decode_step(
            self.params, tokens[:, None], cache)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate(self, batch, *, generator: Optional[torch.Generator] = None
                 ) -> GenerationResult:
        cfg = self.model.cfg
        extra = cfg.num_patches if cfg.family == "vlm" else 0
        cap = batch["tokens"].shape[1] + extra + self.max_new
        last_logits, cache = self.prefill(batch, cap)
        tok = self._sample(last_logits, generator)
        done = torch.zeros_like(tok, dtype=torch.bool)
        out = [tok]
        for _ in range(self.max_new - 1):
            logits, cache = self.decode_step(tok, cache)
            nxt = self._sample(logits, generator)
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == self.eos_id)
            out.append(nxt)
            tok = nxt
        tokens = torch.stack(out, dim=1)
        num = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=tokens.device)
        return GenerationResult(tokens=tokens, num_generated=num)
