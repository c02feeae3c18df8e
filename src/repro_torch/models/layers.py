"""Shared model building blocks on plain dicts of tensors.

Parameter names follow the JAX package's (``scale``, ``embedding``,
``lm_head``, ``w_gate``/``w_up``/``w_down``), so :mod:`repro_torch.convert`
maps one tree onto the other.

Tensor parallelism (the Megatron pattern, where the reference lets GSPMD
place its storage specs): with ``group``, the model axis's process group,
the params are this rank's slices.  :func:`mlp` is column-parallel in
``w_gate``/``w_up`` and row-parallel in ``w_down``; :func:`embed` looks up
the rows of its vocab range; :func:`unembed` gives this rank's vocab
columns of the logits and :func:`cross_entropy` their loss over the whole
vocab without gathering them.  Row-parallel partials are f32 and summed
in f32 before the one cast to the activations' dtype.

Sequence parallelism (``seq``, the reference's ``seq_shard``): a
tensor-parallel module's input is the sequence gathered over the group
(``context.gather_seq``, whose backward sums the ranks' partial input
gradients, so the module takes no ``copy_to``), and its row-parallel
partials are reduce-scattered back to this rank's chunk of the sequence
(``context.scatter_seq``) instead of summed whole.  :func:`sublayer`
places a module so, and :func:`norm` gives the norms that run on a
rank's chunk their summed scale gradient.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.grouped_gemm import (dense_ffn_fp8, dense_linear_fp8,
                                           dense_linear_fp8_fused)
from repro_torch.distributed import context as dctx
from repro_torch.kernels import plan as plan_mod


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


def _wide(dtype: torch.dtype) -> torch.dtype:
    """f32, or ``dtype`` where it is wider: the dtype partials sum in."""
    return torch.promote_types(dtype, torch.float32)


class _WideProduct(torch.autograd.Function):
    """``h @ w`` of two 16-bit operands on the card as one GEMM with an
    f32 output (exact products, f32 sums, no rounding of the result).
    Its output feeds only :func:`row_parallel`'s sum and one cast back to
    h's dtype, so the gradient it receives is a 16-bit value: the
    backward takes it in that dtype, as one process's product does."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        y = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        g = dy.to(h.dtype)
        return g @ w.t(), (h.reshape(-1, h.shape[-1]).t()
                           @ g.reshape(-1, g.shape[-1]))


def tp_out(y, group, seq: bool, dtype):
    """A row-parallel module's f32 partials ``y`` [B, S, ...], summed over
    ``group`` (reduce-scattered over the sequence where ``seq``) and cast
    once to ``dtype``."""
    y = dctx.scatter_seq(y, group) if seq else dctx.reduce_from(y, group)
    return y.to(dtype)


def row_parallel(h, w, group, seq: bool = False):
    """``h @ w`` for a row slice ``w`` of the weight: this rank's f32
    partial, summed over ``group`` in f32 (:func:`tp_out`) and cast once
    to h's dtype.  16-bit operands on the card stay 16-bit
    (:class:`_WideProduct`); elsewhere, and for f32 / f64 models, the
    product runs in the wider of f32 and h's dtype."""
    if h.is_cuda and h.dtype == w.dtype and \
            h.dtype in (torch.bfloat16, torch.float16):
        y = _WideProduct.apply(h, w)
    else:
        wide = _wide(h.dtype)
        y = h.to(wide) @ w.to(wide)
    return tp_out(y, group, seq, h.dtype)


def tp_in(x, group, seq: bool):
    """A tensor-parallel module's input: ``copy_to`` (each rank's gradient
    is a part) unless it is the gathered sequence, whose gather sums
    the parts."""
    return x if seq else dctx.copy_to(x, group)


def norm(p, x, eps, group=None):
    """:func:`rms_norm`; with ``group`` (a norm on this rank's chunk of a
    sequence-parallel residual) the scale's gradient is summed over it."""
    if group is not None:
        p = {"scale": dctx.copy_to(p["scale"], group)}
    return rms_norm(p, x, eps)


def sublayer(fn, h, group, split: bool, sp: bool):
    """``fn(h, g, seq) -> (y, extra)`` placed on the model axis ``group``:
    tensor-parallel over it where ``split`` (``g`` is the group), whole
    on every rank otherwise (``g`` None).  With ``sp`` (``h`` is this
    rank's chunk of a sequence-parallel residual) a split module takes
    the gathered sequence and reduce-scatters its output (``seq``
    True); a whole one runs on the gathered sequence, replicated, and
    keeps this rank's chunk of its output."""
    g = group if split else None
    if not sp:
        return fn(h, g, False)
    if g is None:
        y, extra = fn(dctx.gather_seq(h, group, grad="own"), None, False)
        return dctx.split_seq(y, group), extra
    return fn(dctx.gather_seq(h, group), g, True)


def _check_fp8_slice(precision: str, width: int, n: int) -> None:
    """Raise where an ``n``-way slice of the MLP's ``d_ff`` (``width``,
    whole) would leave the fp8 kernels that one process runs on it: they
    need a multiple of 128."""
    if precision == "fp8" and width % 128 == 0 and (width // n) % 128:
        raise ValueError(
            f"the MLP's d_ff: a {n}-way slice of width {width} is "
            f"{width // n} columns, no multiple of 128, so the fp8 kernels "
            f"that one process runs would drop to a bf16 matmul; use a "
            f"model axis whose slice is a multiple of 128, or "
            f"precision='bf16'")


def mlp(p, x, act: str = "swiglu", *, precision="bf16", config=None,
        group=None, seq: bool = False):
    """SwiGLU (``silu(x w_gate) * (x w_up)``) or tanh-GELU MLP, then
    ``w_down``.  fp8 with 128-multiple widths: the activation and its
    1x128 quantization run fused into the down GEMM's input; with
    ``config.fuse_producer`` the gate/up GEMMs store fp8 themselves.
    bf16: the activation in x's dtype, one rounding per operation, as the
    reference's.  With ``group`` the weights are this rank's ``d_ff``
    slice: the down product's f32 partials are summed over the group
    (reduce-scattered over the sequence where ``seq``)."""
    f, d_out = p["w_down"].shape
    n = dctx.group_size(group)
    tp = n > 1
    if tp:
        _check_fp8_slice(precision, f * n, n)
        x = tp_in(x, group, seq)
    out_dtype = _wide(x.dtype) if tp else None

    def done(y):
        return tp_out(y, group, seq, x.dtype) if tp else y.to(x.dtype)
    if (precision == "fp8" and config is not None and config.fuse_producer
            and x.shape[-1] % 128 == 0 and f % 128 == 0 and d_out % 128 == 0):
        # producer-fused FFN: one quantization of x, nothing wider than
        # fp8 between the three GEMMs
        gate = p["w_gate"] if act == "swiglu" else None
        return done(dense_ffn_fp8(
            x, gate, p["w_up"], p["w_down"],
            act="silu_mul" if act == "swiglu" else "gelu", config=config,
            out_dtype=out_dtype))
    up = linear(x, p["w_up"], precision=precision, config=config)
    fused = precision == "fp8" and f % 128 == 0 and d_out % 128 == 0
    if act == "swiglu":
        gate = linear(x, p["w_gate"], precision=precision, config=config)
        if fused:
            # fused activation-quantize epilogue: h never materializes
            return done(dense_linear_fp8_fused(
                gate, up, p["w_down"], act="silu_mul", config=config,
                out_dtype=out_dtype))
        h = gate * torch.sigmoid(gate) * up
    else:  # gelu
        if fused:
            return done(dense_linear_fp8_fused(
                up, None, p["w_down"], act="gelu", config=config,
                out_dtype=out_dtype))
        h = F.gelu(up, approximate="tanh")
    if tp:
        return row_parallel(h, p["w_down"], group, seq)
    return linear(h, p["w_down"], precision=precision, config=config)


def init_embedding(vocab, d, dtype, tie: bool, *, generator, device):
    p = {"embedding": ninit((vocab, d), d ** -0.5, dtype,
                            generator=generator, device=device)}
    if not tie:
        p["lm_head"] = ninit((d, vocab), d ** -0.5, dtype,
                             generator=generator, device=device)
    return p


def _vocab_range(width: int, group) -> "tuple[int, int]":
    """(first id, ids) of this rank's contiguous slice of the vocab."""
    return dist.get_rank(group) * width, width


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp - gold`` of f32 logits split over the vocab:
    the max, the sum of exponentials and the gold logit are reduced over
    the group (two collectives); the gradient, ``softmax - onehot`` of
    this rank's columns, is local."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        lo, width = _vocab_range(logits.shape[-1], group)
        m = dctx.all_reduce(logits.amax(dim=-1), group,
                            op=dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        t = labels.long() - lo
        inside = (t >= 0) & (t < width)
        t = t.clamp(0, width - 1)
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
        sums = dctx.all_reduce(torch.stack(
            [e.sum(dim=-1), torch.where(inside, gold, 0.0)]), group)
        ctx.save_for_backward(e.div_(sums[0][..., None]), t, inside)
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, dnll):
        soft, t, inside = ctx.saved_tensors
        grad = soft * dnll[..., None]
        grad.scatter_add_(-1, t[..., None],
                          -torch.where(inside, dnll, 0.0)[..., None])
        return grad, None, None


def cross_entropy(logits, labels, group=None):
    """Mean token cross-entropy in f32; labels < 0 are ignored.  With
    ``group``, ``logits`` are this rank's vocab columns
    (:func:`unembed`'s) and the loss is the whole vocab's."""
    logits = logits.float()
    if dctx.group_size(group) > 1:
        nll = _VocabParallelNLL.apply(logits, labels, group)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
        nll = logz - gold
    valid = (labels >= 0).float()
    return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1.0)


def embed(p, tokens, group=None):
    """The embedding rows of ``tokens``.  With ``group`` the table is this
    rank's vocab slice: each rank looks up the ids in its range, zeros
    the others, and the group sums (one rank's row is nonzero: exact)."""
    # F.embedding's backward adds each row's gradients in a fixed order
    # (an indexing gather's accumulates across threads in any order), so
    # a resumed run repeats an uninterrupted one bit for bit
    w = p["embedding"]
    if dctx.group_size(group) == 1:
        return F.embedding(tokens.long(), w)
    lo, width = _vocab_range(w.shape[0], group)
    t = tokens.long() - lo
    inside = (t >= 0) & (t < width)
    y = F.embedding(t.clamp(0, width - 1), w)
    y = torch.where(inside[..., None], y.to(_wide(w.dtype)), 0.0)
    return dctx.reduce_from(y, group).to(w.dtype)


def unembed(p, x, group=None):
    """Logits of ``x``; with ``group``, this rank's vocab columns (the
    tied embedding's rows of its slice, or its ``lm_head`` columns)."""
    if dctx.group_size(group) > 1:
        x = dctx.copy_to(x, group)
    if "lm_head" in p:
        return x @ p["lm_head"].to(x.dtype)
    return x @ p["embedding"].to(x.dtype).T


def remat_scope(fn):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant; nothing of
    its activations is kept): the backward recomputes it under the
    kernel-config scope (``plan.default_config``) of the forward, which
    the trainer's loss may have set and left before the backward."""
    scoped = plan_mod.pinned_default()

    def contexts():
        return contextlib.nullcontext(), plan_mod.default_config(scoped)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=contexts)
    return run
