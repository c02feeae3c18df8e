"""Deterministic, stateless synthetic token pipeline: a copy of the JAX
package's ``data/pipeline.py`` (numpy only).

Every batch is a pure function of (seed, step), so a restarted run
regenerates identical batches.  The "dataset" is one fixed cyclic token
pattern per seed, sampled at random phases with 5% token noise, so a
model shows a real, decreasing loss rather than ln(V) noise.
:meth:`SyntheticLM.batch_at` is bitwise the JAX package's batch, moved
to the pipeline's device: the audio family's batches also carry
``frames`` and a VLM's ``patch_embeds``, f32 normal draws from the same
generator in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 128
    repeat_period: int = 16      # structure the stream so loss can fall


class SyntheticLM:
    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 device="cpu"):
        self.cfg = cfg
        self.mcfg = model_cfg
        self.device = torch.device(device)

    def batch_np(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays (tokens and labels int32,
        frames and patch embeddings f32)."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        v = self.mcfg.vocab_size
        # one fixed cyclic pattern per dataset seed (memorizable: the
        # bigram token->successor map is deterministic), sampled at random
        # phases per row, with 5% token noise
        base_rng = np.random.default_rng(c.seed)
        base = base_rng.permutation(v)[:c.repeat_period]
        reps = int(np.ceil(c.seq_len / c.repeat_period)) + 1
        stream = np.tile(base, reps)
        phase = rng.integers(0, c.repeat_period, c.batch_size)
        tokens = np.stack([stream[p:p + c.seq_len] for p in phase])
        noise_mask = rng.random(tokens.shape) < 0.05
        tokens = np.where(noise_mask,
                          rng.integers(0, v, tokens.shape), tokens)
        batch = {"tokens": tokens.astype(np.int32),
                 "labels": tokens.astype(np.int32)}
        m = self.mcfg
        if m.family == "audio":
            batch["frames"] = rng.standard_normal(
                (c.batch_size, m.encoder_seq, m.d_model)).astype(np.float32)
        if m.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (c.batch_size, m.num_patches, m.patch_embed_dim)
            ).astype(np.float32)
        return batch

    def batch_at(self, step: int) -> dict:
        return {k: torch.from_numpy(a).to(self.device)
                for k, a in self.batch_np(step).items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
