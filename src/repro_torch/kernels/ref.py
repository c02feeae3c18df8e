"""Plain PyTorch oracles for the quantizers, the grouped GEMM and
attention.

Quantization scheme follows the paper (= DeepSeek-V3):
  * ``A``  fp8 e4m3, one scale per 1x128 tile:   S_A[m, ceil(K/128)]  (f32)
  * ``B``  fp8 e4m3, one scale per 128x128 block: S_B[g, ceil(K/128), ceil(N/128)]
  * ``C``  bf16, accumulated in f32 with per-K-block rescale.

The oracles accept K (and N) that are not multiples of 128 by padding;
the kernels do not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

QUANT_BLOCK = 128  # the paper's 1x128 / 128x128 quantization granularity
FP8_MAX = 448.0    # float8_e4m3fn max normal
FP8 = torch.float8_e4m3fn
# XLA compiles the reference's ``amax / 448`` into a multiplication by the
# f32 reciprocal of 448 (it rewrites every division by a constant), so the
# port computes the scale that way to agree with it bit for bit.  The
# division of the values by the scale stays a real IEEE divide.
FP8_MAX_RECIP = float(torch.tensor(1.0 / FP8_MAX, dtype=torch.float32))


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """Scale of a tile or block from its f32 amax: ``amax * f32(1/448)``,
    1.0 for an all-zero tile."""
    return torch.where(amax > 0, amax * FP8_MAX_RECIP, torch.ones_like(amax))


def quantize_tilewise_ref(a: torch.Tensor, block: int = QUANT_BLOCK):
    """1 x ``block`` per-tile symmetric fp8 quantization of a 2-D activation.

    Returns ``(a_fp8[m, k], s_a[m, ceil(k/block)])`` with
    ``a ~= a_fp8 * repeat(s_a, block, dim=1)``.
    """
    m, k = a.shape
    kb = (k + block - 1) // block
    ap = a.float()
    if kb * block != k:
        ap = F.pad(ap, (0, kb * block - k))
    tiles = ap.reshape(m, kb, block)
    scale = scale_of(tiles.abs().amax(dim=-1))
    q = (tiles / scale[..., None]).reshape(m, kb * block)[:, :k]
    return q.to(FP8), scale


ACTIVATIONS = ("silu_mul", "gelu")


def act_f32(g: torch.Tensor, u: torch.Tensor | None, act: str) -> torch.Tensor:
    """The activation in f32, the definition the kernel repeats: silu as
    ``g * sigmoid(g)``, gelu in its tanh form."""
    gf = g.float()
    if act == "silu_mul":
        return gf * torch.sigmoid(gf) * u.float()
    if act == "gelu":
        return F.gelu(gf, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}; expected {ACTIVATIONS}")


def act_quantize_ref(g: torch.Tensor, u: torch.Tensor | None = None,
                     act: str = "silu_mul", block: int = QUANT_BLOCK):
    """Unfused oracle of the fused activation -> quantize epilogue: the
    activation in f32, then :func:`quantize_tilewise_ref`."""
    return quantize_tilewise_ref(act_f32(g, u, act), block)


def quantize_blockwise_ref(b: torch.Tensor, block: int = QUANT_BLOCK):
    """``block`` x ``block`` per-block symmetric fp8 quantization of a
    weight; leading dims are batch dims.

    ``b``: [..., k, n] -> ``(b_fp8[..., k, n], s_b[..., ceil(k/block),
    ceil(n/block)])``.
    """
    *lead, k, n = b.shape
    kb = (k + block - 1) // block
    nb = (n + block - 1) // block
    bp = b.float()
    if (kb * block, nb * block) != (k, n):
        bp = F.pad(bp, (0, nb * block - n, 0, kb * block - k))
    blocks = bp.reshape(*lead, kb, block, nb, block)
    scale = scale_of(blocks.abs().amax(dim=(-3, -1)))     # [..., kb, nb]
    q = (blocks / scale[..., :, None, :, None]).reshape(
        *lead, kb * block, nb * block)[..., :k, :n]
    return q.to(FP8), scale


def dequantize_tilewise_ref(a_fp8, s_a, block: int = QUANT_BLOCK):
    k = a_fp8.shape[1]
    scales = torch.repeat_interleave(s_a, block, dim=1)[:, :k]
    return a_fp8.float() * scales


def dequantize_blockwise_ref(b_fp8, s_b, block: int = QUANT_BLOCK):
    k, n = b_fp8.shape[-2:]
    scales = torch.repeat_interleave(
        torch.repeat_interleave(s_b, block, dim=-2), block, dim=-1)
    return b_fp8.float() * scales[..., :k, :n]


def grouped_gemm_blockscaled_ref(a_fp8, s_a, b_fp8, s_b, group_sizes,
                                 block: int = QUANT_BLOCK,
                                 out_dtype=torch.bfloat16):
    """Oracle with the kernel's math: per-K-block partial products
    rescaled by ``s_a[:, kb] * s_b[g, kb, nb]`` and accumulated in f32,
    in the order ``(part * s_a) * s_b``.

    a_fp8 [M, K], s_a [M, KB], b_fp8 [G', K, N], s_b [G', KB, NB];
    ``group_sizes`` [G <= G'] with sum == M.  Returns [M, N] ``out_dtype``.
    """
    sizes = [int(s) for s in torch.as_tensor(group_sizes).tolist()]
    k = a_fp8.shape[1]
    n = b_fp8.shape[2]
    kb = (k + block - 1) // block
    nb = (n + block - 1) // block
    out, off = [], 0
    for g, sz in enumerate(sizes):
        acc = torch.zeros((sz, n), dtype=torch.float32, device=a_fp8.device)
        ag = a_fp8[off:off + sz]
        sag = s_a[off:off + sz]
        for ki in range(kb):
            k0, k1 = ki * block, min((ki + 1) * block, k)
            part = ag[:, k0:k1].float() @ b_fp8[g, k0:k1].float()
            col_scale = torch.repeat_interleave(s_b[g, ki, :nb], block)[:n]
            acc = acc + part * sag[:, ki:ki + 1] * col_scale[None, :]
        out.append(acc)
        off += sz
    return torch.cat(out, dim=0).to(out_dtype)


def gmm_quant_ref(a_fp8, s_a, b_fp8, s_b, group_sizes,
                  block: int = QUANT_BLOCK, out_dtype=torch.bfloat16):
    """Oracle of the quantizing-store grouped GEMM: the product of
    :func:`grouped_gemm_blockscaled_ref` on the owned rows, zeros below,
    rounded through ``out_dtype`` and quantized 1x128 (the rounding point
    of the reference's unfused composition).  Rows >= sum(group_sizes)
    come back as payload 0 and scale 1.

    a_fp8 [M, K], group_sizes [G] with sum <= M -> (e4m3 [M, N],
    f32 [M, N/128]).
    """
    sizes = [int(s) for s in torch.as_tensor(group_sizes).tolist()]
    total = sum(sizes)
    y = torch.zeros((a_fp8.shape[0], b_fp8.shape[2]), dtype=torch.float32,
                    device=a_fp8.device)
    if total:
        y[:total] = grouped_gemm_blockscaled_ref(
            a_fp8[:total], s_a[:total], b_fp8, s_b, sizes, block,
            out_dtype=torch.float32)
    return quantize_tilewise_ref(y.to(out_dtype).float(), block)


def gmm_bf16_exact_ref(x, w, group_sizes, block: int = QUANT_BLOCK,
                       out_dtype=torch.bfloat16):
    """Oracle of the bf16 grouped GEMM with its reduction order, the
    function of the JAX package's ``gmm_bf16_xla_exact``: operands rounded
    to bf16 and upcast to f32, one f32 dot per (group, 128-K block) over
    the group's rows, the blocks added in f32.  Rows >= sum(group_sizes)
    are exactly zero.  Reads the group sizes back to the host.

    x [M, K], w [G', K, N], group_sizes [G <= G'] with sum <= M ->
    [M, N] ``out_dtype``.
    """
    sizes = [int(s) for s in torch.as_tensor(group_sizes).tolist()]
    x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    k, n = x.shape[1], w.shape[2]
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    off = 0
    for g, sz in enumerate(sizes):
        for k0 in range(0, k, block) if sz else ():
            part = x16[off:off + sz, k0:k0 + block].float() \
                @ w16[g, k0:k0 + block].float()
            acc[off:off + sz] = acc[off:off + sz] + part
        off += sz
    return acc.to(out_dtype)


def wgrad_exact_ref(x, dy, group_sizes, *, num_groups=None,
                    out_dtype=torch.float32):
    """Oracle of the wgrad, ``dw[g] = x_g^T @ dy_g`` contracted in f32,
    one group at a time: the function of the JAX package's one-hot
    ``wgrad_xla_exact`` oracle.  Rows at or beyond ``sum(group_sizes)``
    never enter, whatever they hold (NaN included); groups with no rows,
    and groups past ``len(group_sizes)`` up to ``num_groups``, are zero.
    Reads the group sizes back to the host.

    x [M, K], dy [M, N], group_sizes [G] -> [num_groups or G, K, N]
    ``out_dtype``.
    """
    sizes = [int(s) for s in torch.as_tensor(group_sizes).tolist()]
    dw = torch.zeros((num_groups or len(sizes), x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    off = 0
    for g, sz in enumerate(sizes):
        if sz:
            dw[g] = x[off:off + sz].float().T @ dy[off:off + sz].float()
        off += sz
    return dw.to(out_dtype)


def wgrad_fp8_exact_ref(x_fp8, s_x, dy_fp8, s_dy, group_sizes, *,
                        num_groups=None, out_dtype=torch.float32):
    """fp8-operand oracle: dequantize both operands exactly in f32 (the
    1x128 row-tile layout is the same on the x and dy sides), then
    :func:`wgrad_exact_ref`."""
    return wgrad_exact_ref(dequantize_tilewise_ref(x_fp8, s_x),
                           dequantize_tilewise_ref(dy_fp8, s_dy),
                           group_sizes, num_groups=num_groups,
                           out_dtype=out_dtype)


#: the score of a masked (q, k) pair: finite, so ``exp(s - m)`` underflows
#: to 0 instead of making NaN from ``-inf - -inf``
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Oracle of flash attention, the JAX package's
    ``flash_attention_ref``: f32 scores ``q k^T * D**-0.5``, ``NEG_INF``
    above the diagonal when ``causal``, softmax, ``p @ v``, cast to q's
    dtype.

    q [B, Hq, S, D], k/v [B, Hkv, Sk, D] with Hq % Hkv == 0: q-head ``h``
    reads kv-head ``h // (Hq/Hkv)`` (``repeat_interleave``, as the JAX
    package's ``jnp.repeat``; ``Tensor.repeat`` would map ``h`` to ``h %
    Hkv``).
    """
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, g, dim=1).float()
    vx = torch.repeat_interleave(v, g, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * d ** -0.5
    if causal:
        mask = torch.ones((s, k.shape[2]), dtype=torch.bool,
                          device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
