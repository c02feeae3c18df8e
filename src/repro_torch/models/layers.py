"""Shared model building blocks on plain dicts of tensors.

Parameter names follow the JAX package's (``scale``, ``embedding``,
``lm_head``), so :mod:`repro_torch.convert` maps one tree onto the other.
``mlp`` is not ported: no ported model has a dense MLP.  It comes with the
model zoo's dense families (ROADMAP A9), after flash attention.
"""
from __future__ import annotations

import torch


def ninit(shape, scale, dtype, *, generator: torch.Generator, device):
    """Normal(0, 1) * scale, drawn in f32 from ``generator`` on ``device``."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def init_rms_norm(d, *, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)   # [..., S, 1, half]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(vocab, d, dtype, tie: bool, *, generator, device):
    p = {"embedding": ninit((vocab, d), d ** -0.5, dtype,
                            generator=generator, device=device)}
    if not tie:
        p["lm_head"] = ninit((d, vocab), d ** -0.5, dtype,
                             generator=generator, device=device)
    return p


def cross_entropy(logits, labels):
    """Mean token cross-entropy in f32; labels < 0 are ignored."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((logz - gold) * valid) / torch.clamp(valid.sum(),
                                                         min=1.0)


def embed(p, tokens):
    return p["embedding"][tokens]


def unembed(p, x):
    if "lm_head" in p:
        return x @ p["lm_head"].to(x.dtype)
    return x @ p["embedding"].to(x.dtype).T
