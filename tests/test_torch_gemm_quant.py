"""The port's plain quantizing grouped GEMM (B7) against the JAX package's
Pallas kernel ``gmm_pallas_quant``, and the fused activation quantizer's
fp8-input mode (B3) against ``act_quantize_pallas(s_g=, s_u=)``, both in
interpret mode on the CPU.

The quantizing GEMM rounds the product through bf16 before its 1x128
quantization.  The two packages' GEMMs sum each 128-K block in another
order, which can flip that bf16 rounding and, at a tile's amax, its
scale: the dequantized values are held within one e4m3 step of the
value plus the GEMM's one-bf16-step tolerance.  Tail rows (>=
sum(group_sizes)) must come back as payload 0 and scale 1 exactly.  The
activation quantizer's fp8 mode dequantizes bitwise-equal inputs; silu's
exp may round an ulp apart between XLA and PyTorch: one e4m3 step.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import quantization as jquant
from repro.kernels import ref as jref
from repro.kernels.epilogue_kernel import act_quantize_pallas
from repro.kernels.grouped_gemm_kernel import gmm_pallas_quant
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import epilogue_kernel as tek
from repro_torch.kernels import grouped_gemm_kernel as tgk
from repro_torch.kernels import ref as tref
from repro_torch.kernels.plan import make_tile_plan

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and beside the other test workers a thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # name: (M, K, N, group sizes, block_m[, block_n])
    "ragged_tail": (100, 256, 256, [30, 0, 50, 7], 128),
    "ragged_bm16": (70, 256, 256, [0, 16, 1, 33, 0, 20], 16),
    "all_empty": (48, 128, 256, [0, 0, 0], 16),
    # every owned span 1..16 of a 16-row tile (groups of i + 1 and 15 - i
    # rows), then 8 tail rows
    "spans_bm16": (264, 128, 256,
                   [s for i in range(16) for s in (i + 1, 15 - i)], 16),
    # an odd number of 128-K blocks
    "odd_k_blocks": (90, 640, 256, [33, 0, 40], 128),
    # owned runs crossing the 64-row slab (rows 40-89) and the 128-row tile
    # (rows 90-149) at block_m 128
    "slab_crossing": (160, 256, 256, [40, 50, 60], 128),
    # fewer rows than the tile: decode's shared experts
    "m_below_tile": (4, 256, 256, [4], 16),
    "empty_groups_full": (64, 128, 128, [0, 64, 0, 0], 16),
    # every pool geometry the cases above do not take (block_m 8, 64, 256
    # and 512, block_n 256 at block_m 128): residue groups of 2^i - 1,
    # 2^i and 2^i + 1 rows around the tile, an empty group, tail rows
    "residues_bm8": (70, 256, 256, [1, 2, 3, 0, 7, 8, 9, 15, 17], 8, 128),
    "residues_bm64": (300, 256, 256, [1, 63, 0, 64, 65, 31, 33, 2], 64, 128),
    "residues_bm128_bn256": (400, 256, 256, [127, 129, 0, 1, 63, 65], 128,
                             256),
    "residues_bm256": (700, 128, 256, [255, 0, 257, 1, 129, 3], 256, 128),
    "residues_bm512": (1100, 128, 256, [511, 2, 0, 513, 17], 512, 128),
}


def geometry(case):
    """``(M, K, N, group sizes, block_m, block_n)`` of a case (block_n 128
    where the case names none)."""
    m, k, n, sizes, bm, *bn = CASES[case]
    return m, k, n, sizes, bm, (bn or [128])[0]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def e4m3_step(q):
    a = np.abs(np.asarray(q, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -6))) - 3)


def dequant(q, s):
    return np.asarray(q, np.float32) * np.repeat(np.asarray(s), 128, axis=1)


def operands(m, k, n, g, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((g, k, n)) * k ** -0.5).astype(np.float32)
    ja, jsa = jax.jit(jref.quantize_tilewise_ref)(jnp.asarray(a))
    jb, jsb = jax.jit(jquant.quantize_blockwise_batched)(jnp.asarray(w))
    t = [tensor_from_numpy(np.asarray(v)) for v in (ja, jsa, jb, jsb)]
    return (ja, jsa, jb, jsb), t


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gmm_quant_matches_pallas(case):
    m, k, n, sizes, bm, bn = geometry(case)
    (ja, jsa, jb, jsb), (ta, tsa, tb, tsb) = operands(m, k, n, len(sizes), 0)
    jq, js = gmm_pallas_quant(ja, jsa, jb, jsb, jnp.array(sizes, jnp.int32),
                              block_m=bm, block_n=bn, interpret=True)
    gs = torch.tensor(sizes, dtype=torch.int32)
    tq, ts = tgk.gmm_quant(ta, tsa, tb, tsb, gs, block_m=bm, block_n=bn)
    assert tq.dtype == torch.float8_e4m3fn and tq.shape == (m, n)
    assert ts.dtype == torch.float32 and ts.shape == (m, n // 128)
    total = sum(sizes)
    # the tail, and every row of an all-empty plan: payload 0, scale 1
    assert (tq[total:].view(torch.uint8) == 0).all()
    assert (ts[total:] == 1).all()
    np.testing.assert_array_equal(np.asarray(js)[total:], 1.0)
    jd, td = dequant(_np(jq), js), dequant(tq.float().numpy(), ts.numpy())
    step = np.maximum(e4m3_step(_np(jq)) * np.repeat(np.asarray(js), 128, 1),
                      e4m3_step(tq.float().numpy())
                      * np.repeat(ts.numpy(), 128, 1))
    tol = step + np.abs(jd) * 2.0 ** -7 + 1e-4 * np.abs(jd).max() + 1e-30
    assert np.all(np.abs(td - jd) <= tol), np.abs(td - jd).max()
    # the plain version is the quantizer applied to the plain GEMM's
    # bf16 output, bitwise
    y = tgk.gmm(ta, tsa, tb, tsb, gs, block_m=bm, block_n=bn)
    rq, rs = tref.quantize_tilewise_ref(y.float())
    np.testing.assert_array_equal(rq.view(torch.uint8).numpy(),
                                  tq.view(torch.uint8).numpy())
    np.testing.assert_array_equal(rs.numpy(), ts.numpy())


def test_gmm_quant_rounds_through_out_dtype_and_checks():
    m, k, n, sizes, bm = CASES["ragged_tail"]
    _, (ta, tsa, tb, tsb) = operands(m, k, n, len(sizes), 1)
    gs = torch.tensor(sizes, dtype=torch.int32)
    plan = make_tile_plan(gs, m, block_m=bm)
    q32, s32 = tgk.gmm_quant(ta, tsa, tb, tsb, gs, block_m=bm, plan=plan,
                             out_dtype=torch.float32)
    y32 = tgk.gmm(ta, tsa, tb, tsb, gs, block_m=bm, out_dtype=torch.float32)
    rq, rs = tref.quantize_tilewise_ref(y32)
    assert torch.equal(q32.view(torch.uint8), rq.view(torch.uint8))
    assert torch.equal(s32, rs)
    with pytest.raises(ValueError, match="s_a"):
        tgk.gmm_quant(ta, tsa[:, :1].contiguous(), tb, tsb, gs)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gmm_quant_cuda(ta, tsa, tb, tsb, gs)
    before = tgk.gmm_quant_cuda.launches
    tgk.gmm_quant(ta, tsa, tb, tsb, gs)
    assert tgk.gmm_quant_cuda.launches == before
    q0, s0 = tgk.gmm_quant(ta[:0], tsa[:0], tb, tsb,
                           torch.zeros(4, dtype=torch.int32))
    assert q0.shape == (0, n) and s0.shape == (0, n // 128)


@pytest.mark.parametrize("act", ["silu_mul", "gelu"])
def test_act_quantize_fp8_mode_within_one_e4m3_step(act):
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((48, 384)) * 2).astype(np.float32)
    u = (rng.standard_normal((48, 384)) * 2).astype(np.float32)
    quant = jax.jit(jref.quantize_tilewise_ref)
    jg8, jsg = quant(jnp.asarray(g))
    ju8, jsu = quant(jnp.asarray(u))
    unary = act == "gelu"
    jq, js = act_quantize_pallas(jg8, None if unary else ju8, s_g=jsg,
                                 s_u=None if unary else jsu, act=act,
                                 interpret=True)
    tg8, tsg, tu8, tsu = (tensor_from_numpy(np.asarray(v))
                          for v in (jg8, jsg, ju8, jsu))
    tq, ts = tek.act_quantize(tg8, None if unary else tu8, s_g=tsg,
                              s_u=None if unary else tsu, act=act)
    jq_f, tq_f = _np(jq), tq.float().numpy()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-6, atol=0)
    step = np.maximum(e4m3_step(jq_f) * np.repeat(np.asarray(js), 128, 1),
                      e4m3_step(tq_f) * np.repeat(ts.numpy(), 128, 1))
    diff = np.abs(dequant(jq_f, js) - dequant(tq_f, ts.numpy()))
    assert np.all(diff <= step * (1 + 1e-5))
    # the fp8 mode is the bf16/f32 mode on the dequantized operands
    dg = tref.dequantize_tilewise_ref(tg8, tsg)
    du = None if unary else tref.dequantize_tilewise_ref(tu8, tsu)
    rq, rs = tek.act_quantize(dg, du, act=act)
    assert torch.equal(rq.view(torch.uint8), tq.view(torch.uint8))
    assert torch.equal(rs, ts)
    # a CPU tensor never reaches the kernel
    before = tek.act_quantize_cuda.fp8_launches
    with pytest.raises(ValueError, match="CUDA"):
        tek.act_quantize_cuda(tg8, None if unary else tu8, s_g=tsg,
                              s_u=None if unary else tsu, act=act)
    assert tek.act_quantize_cuda.fp8_launches == before
