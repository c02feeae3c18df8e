"""Shared model building blocks on plain dicts of tensors.

Parameter names follow the JAX package's (``scale``, ``embedding``,
``lm_head``, ``w_gate``/``w_up``/``w_down``), so :mod:`repro_torch.convert`
maps one tree onto the other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.grouped_gemm import (dense_ffn_fp8, dense_linear_fp8,
                                           dense_linear_fp8_fused)


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


def linear(x, w, *, precision: str = "bf16", config=None):
    """2-D weight product, with the DeepSeek-style fp8 path (the G=1 case
    of the grouped GEMM) where both widths are multiples of 128; otherwise
    a plain ``torch.matmul`` in x's dtype, as the JAX package leaves it to
    XLA.  ``config``: the :class:`~repro_torch.kernels.plan.KernelConfig`
    of the tile shapes."""
    if precision == "fp8" and x.shape[-1] % 128 == 0 \
            and w.shape[-1] % 128 == 0:
        lead = x.shape[:-1]
        y = dense_linear_fp8(x.reshape(-1, x.shape[-1]), w, config=config)
        return y.reshape(*lead, w.shape[-1]).to(x.dtype)
    return x @ w.to(x.dtype)


def init_mlp(d, f, act: str, dtype, *, generator, device):
    kw = dict(generator=generator, device=device)
    p = {"w_up": ninit((d, f), d ** -0.5, dtype, **kw),
         "w_down": ninit((f, d), f ** -0.5, dtype, **kw)}
    if act == "swiglu":
        p["w_gate"] = ninit((d, f), d ** -0.5, dtype, **kw)
    return p


def mlp(p, x, act: str = "swiglu", *, precision="bf16", config=None):
    """SwiGLU (``silu(x w_gate) * (x w_up)``) or tanh-GELU MLP, then
    ``w_down``.  fp8 with 128-multiple widths: the activation and its
    1x128 quantization run fused into the down GEMM's input; with
    ``config.fuse_producer`` the gate/up GEMMs store fp8 themselves.
    bf16: the activation in x's dtype, one rounding per operation, as the
    reference's."""
    f, d_out = p["w_down"].shape
    if (precision == "fp8" and config is not None and config.fuse_producer
            and x.shape[-1] % 128 == 0 and f % 128 == 0 and d_out % 128 == 0):
        # producer-fused FFN: one quantization of x, nothing wider than
        # fp8 between the three GEMMs
        gate = p["w_gate"] if act == "swiglu" else None
        y = dense_ffn_fp8(x, gate, p["w_up"], p["w_down"],
                          act="silu_mul" if act == "swiglu" else "gelu",
                          config=config)
        return y.to(x.dtype)
    up = linear(x, p["w_up"], precision=precision, config=config)
    fused = precision == "fp8" and f % 128 == 0 and d_out % 128 == 0
    if act == "swiglu":
        gate = linear(x, p["w_gate"], precision=precision, config=config)
        if fused:
            # fused activation-quantize epilogue: h never materializes
            y = dense_linear_fp8_fused(gate, up, p["w_down"], act="silu_mul",
                                       config=config)
            return y.to(x.dtype)
        h = gate * torch.sigmoid(gate) * up
    else:  # gelu
        if fused:
            y = dense_linear_fp8_fused(up, None, p["w_down"], act="gelu",
                                       config=config)
            return y.to(x.dtype)
        h = F.gelu(up, approximate="tanh")
    return linear(h, p["w_down"], precision=precision, config=config)


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
    # F.embedding's backward adds each row's gradients in a fixed order
    # (an indexing gather's accumulates across threads in any order), so
    # a resumed run repeats an uninterrupted one bit for bit
    return F.embedding(tokens.long(), p["embedding"])


def unembed(p, x):
    if "lm_head" in p:
        return x @ p["lm_head"].to(x.dtype)
    return x @ p["embedding"].to(x.dtype).T
