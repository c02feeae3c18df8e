"""Causal GQA flash attention: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Online-softmax attention over 64-row tiles: per q tile, the running max
``m``, denominator ``l`` and accumulator ``acc`` stay in f32 across the k
tiles, and causal k tiles wholly above the diagonal are skipped, so the
[S, S] scores never reach device memory.  q-head ``h`` reads kv-head
``h // (Hq/Hkv)``; k and v are never expanded to the q-head count.

Layout: q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D] in q's
dtype.

:func:`flash_attention` chooses by its tensors: ``FakeTensor``s go to
:func:`flash_attention_abstract` (shape-only,
:mod:`~repro_torch.kernels.abstract`), CPU tensors to
:func:`flash_attention_plain`, CUDA tensors to
:func:`flash_attention_cuda`, which launches the kernel or raises.
:func:`flash_attention_trainable` adds the gradient: as in the JAX
package, the backward recomputes the oracle ``ref.flash_attention_ref``
and takes its gradient (no backward kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import abstract, build
from repro_torch.kernels.plan import flash_attention_work
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: q rows and k rows of one tile
BLOCK = 64
#: head dims the kernel is built for
HEAD_DIMS = (64, 128)


def _check(q, k, v) -> None:
    """The JAX wrapper's checks, with the port's tile."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Hq, S, D] and k, v [B, Hkv, S, D]; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "in batch, sequence or head dim")
    if hq % k.shape[1] != 0:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={k.shape[1]} "
                         f"(GQA group count must be integral); got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if s % BLOCK:
        raise ValueError(f"S={s} must divide into blocks of {BLOCK}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The kernel's arithmetic in PyTorch ops, in f32: per 64-row q tile,
    an online softmax over the 64-row k tiles up to the diagonal (the
    causal skip), ``NEG_INF`` on the masked scores of the diagonal tile,
    then ``acc / max(l, 1e-20)`` cast to q's dtype."""
    _check(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(BLOCK, device=q.device)
    diag = pos[:, None] >= pos[None, :]
    outs = []
    for i in range(s // BLOCK):
        qi = qg[:, :, :, i * BLOCK:(i + 1) * BLOCK].float()
        m = torch.full((b, hkv, g, BLOCK), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l_ = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, BLOCK, d), dtype=torch.float32,
                          device=q.device)
        for j in range(i + 1 if causal else s // BLOCK):
            kj = kf[:, :, j * BLOCK:(j + 1) * BLOCK]
            vj = vf[:, :, j * BLOCK:(j + 1) * BLOCK]
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if causal and j == i:
                sc = torch.where(diag, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vj)
            m = m_new
        outs.append(acc / torch.clamp(l_, min=1e-20)[..., None])
    return torch.cat(outs, dim=3).reshape(b, hq, s, d).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Launch the CUDA kernel: bf16 q/k/v, contiguous and 16-byte aligned
    on one CUDA device, D in :data:`HEAD_DIMS`, S a multiple of
    :data:`BLOCK`.  Allocates the output; runs on the current stream."""
    _check(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                             f"device; {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim D={d} is not built; the kernel takes "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.function("flash_attention", "flash_attention_bf16",
                        [_P] * 4 + [_I] * 6 + [_F, _P])
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, k.shape[1], s, d, int(causal), d ** -0.5,
                build.stream_ptr(q.device))
    build.check(status, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_abstract(q, k, v, *, causal: bool = True):
    """Shape-only :func:`flash_attention`: its checks, the [B, Hq, S, D]
    output in q's dtype and the kernel's work
    (``plan.flash_attention_work``); reads nothing to the host."""
    _check(q, k, v)
    b, hq, s, d = q.shape
    abstract.count("flash_attention", *flash_attention_work(
        b, hq, k.shape[1], s, d, causal, BLOCK))
    return q.new_empty(q.shape)


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D] (q's dtype)."""
    _check(q, k, v)
    if abstract.is_fake(q):
        return flash_attention_abstract(q, k, v, causal=causal)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal)


class _FlashAttention(torch.autograd.Function):
    """Flash forward; the backward recomputes the oracle and takes its
    gradient, as the JAX package's ``_flash_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach() for t in ctx.saved_tensors)
        with torch.enable_grad():
            q.requires_grad_(True)
            k.requires_grad_(True)
            v.requires_grad_(True)
            out = flash_attention_ref(q, k, v, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None


def flash_attention_trainable(q, k, v, causal: bool = True):
    """Differentiable :func:`flash_attention`."""
    return _FlashAttention.apply(q, k, v, causal)
