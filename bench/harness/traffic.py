"""The one generator of traffic: it reads a mix's parameters (a file of
``traffic/``) and draws its inputs from the seed.

``kind: "train"``: batches of ``batch`` x ``seq`` token ids, uniform over
the vocab, a fresh batch each step.  ``kind: "generate"``: batches of
``batch`` prompts of one length; the lengths are ``prompt.fixed``, or
the ``count`` stratified quantiles of a lognormal (``median``, ``sigma``)
clipped to [``min``, ``max``], the same multiset for every seed.  With
``strata``, the sorted lengths fall into that many strata and each round
of batches takes one length of every stratum, in an order drawn from the
seed, so any run of whole rounds holds the same mix of lengths; a
window closes at the end of a round.
"""
from __future__ import annotations

import math
import random
import statistics

import torch


def prompt_lengths(prompt: dict) -> list:
    """The multiset of prompt lengths, sorted."""
    if "fixed" in prompt:
        return [int(prompt["fixed"])]
    ln = prompt["lognormal"]
    nd = statistics.NormalDist(0.0, ln["sigma"])
    out = []
    for i in range(ln["count"]):
        x = ln["median"] * math.exp(nd.inv_cdf((i + 0.5) / ln["count"]))
        out.append(int(min(max(round(x), ln["min"]), ln["max"])))
    return sorted(out)


def round_length(prompt: dict) -> int:
    """Batches in a round of :func:`length_schedule`: every run of whole
    rounds holds the same mix of lengths."""
    return prompt.get("strata", 1)


def length_schedule(prompt: dict, seed: int):
    """An endless iterator of batch lengths drawn from ``seed``."""
    lengths = prompt_lengths(prompt)
    rng = random.Random(seed)
    strata = prompt.get("strata", 1)
    per = len(lengths) // strata
    groups = [lengths[i * per:(i + 1) * per] for i in range(strata)]
    while True:
        perms = [rng.sample(g, len(g)) for g in groups]
        for r in range(per):
            rnd = [p[r] for p in perms]
            rng.shuffle(rnd)
            yield from rnd


class Tokens:
    """Token ids drawn on ``device`` from a generator seeded by ``seed``."""

    def __init__(self, vocab: int, seed: int, device):
        self.vocab = vocab
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 2_654_435_761 + 12345) % (2 ** 63 - 1))
        self.device = device

    def draw(self, batch: int, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (batch, length),
                             generator=self.gen, device=self.device,
                             dtype=torch.int64)
