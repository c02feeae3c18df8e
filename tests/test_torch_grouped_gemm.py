"""The port's plain grouped GEMM against the JAX package's Pallas kernel
``gmm_pallas`` (interpret mode on the CPU), and the fp8 grouped linear
layers against the JAX package's.

Both sum every 128-K block in f32 but in another order, which can flip
the final bf16 rounding: the tolerance is one bf16 step (2^-7 of the
value) plus 1e-4 of the largest output for cancellation near zero.
Structural zeros (rows >= sum(group_sizes), all-empty plans) must match
exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import grouped_gemm as jgg
from repro.core import quantization as jquant
from repro.kernels import ref as jref
from repro.kernels.grouped_gemm_kernel import gmm_pallas
from repro.kernels.plan import KernelConfig as JConfig
from repro_torch.analysis import events
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import grouped_gemm as tgg
from repro_torch.kernels import grouped_gemm_kernel as tgk
from repro_torch.kernels import ref as tref
from repro_torch.kernels.plan import KernelConfig, make_tile_plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and beside the other test workers a thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max() + 1e-30
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


def operands(m, k, n, g, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((g, k, n)) * k ** -0.5).astype(np.float32)
    ja, jsa = jax.jit(jref.quantize_tilewise_ref)(jnp.asarray(a))
    jb, jsb = jax.jit(jquant.quantize_blockwise_batched)(jnp.asarray(w))
    t = [tensor_from_numpy(np.asarray(v)) for v in (ja, jsa, jb, jsb)]
    return (ja, jsa, jb, jsb), t


CASES = {
    # name: (M, K, N, group sizes, block_m[, block_n])
    "ragged_tail": (100, 256, 384, [30, 0, 50, 7], 128),
    "ragged_bm16": (70, 256, 256, [0, 16, 1, 33, 0, 20], 16),
    "decode_bm16": (16, 384, 256, [0, 3, 0, 0, 9, 4, 0, 0], 16),
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
    "single_group": (40, 256, 384, [40], 128),
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gmm_matches_pallas(case):
    m, k, n, sizes, bm, bn = geometry(case)
    (ja, jsa, jb, jsb), (ta, tsa, tb, tsb) = operands(m, k, n, len(sizes), 0)
    want = gmm_pallas(ja, jsa, jb, jsb, jnp.array(sizes, jnp.int32),
                      block_m=bm, block_n=bn, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = tgk.gmm(ta, tsa, tb, tsb, gs, block_m=bm, block_n=bn)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    total = sum(sizes)
    assert (got[total:] == 0).all() and np.all(want[total:] == 0)
    assert_close_bf16(got.float().numpy(), want)
    # the plain version is the port's per-K-block oracle on the owned rows
    if total:
        oracle = tref.grouped_gemm_blockscaled_ref(ta[:total], tsa[:total],
                                                   tb, tsb, gs)
        assert torch.equal(got[:total], oracle)
    # a given plan and an f32 out= buffer give the same result
    plan = make_tile_plan(gs, m, block_m=bm)
    out = torch.full((m, n), float("nan"))
    got32 = tgk.gmm(ta, tsa, tb, tsb, gs, block_m=bm, block_n=bn, plan=plan,
                    out_dtype=torch.float32, out=out)
    assert got32 is out and not torch.isnan(out).any()
    np.testing.assert_array_equal(got32.bfloat16().float().numpy(),
                                  got.float().numpy())


def test_gmm_argument_checks():
    (_, _, _, _), (ta, tsa, tb, tsb) = operands(32, 256, 256, 2, 1)
    gs = torch.tensor([16, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree on K"):
        tgk.gmm(ta[:, :128].contiguous(), tsa[:, :1].contiguous(), tb, tsb, gs)
    with pytest.raises(ValueError, match="s_a"):
        tgk.gmm(ta, tsa[:, :1].contiguous(), tb, tsb, gs)
    plan = make_tile_plan(gs, 32, block_m=16)
    with pytest.raises(ValueError, match="TilePlan built for"):
        tgk.gmm(ta, tsa, tb, tsb, gs, block_m=128, plan=plan)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gmm_cuda(ta, tsa, tb, tsb, gs)
    # a tile outside the built pool raises with the resource model's
    # reason before anything else, in all three entry points
    for tile in ({"block_m": 24}, {"block_k": 256}):
        for fn, args in ((tgk.gmm_cuda, (ta, tsa, tb, tsb, gs)),
                         (tgk.gmm_quant_cuda, (ta, tsa, tb, tsb, gs))):
            with pytest.raises(ValueError, match="no CUDA variant"):
                fn(*args, **tile)
        with pytest.raises(ValueError, match="no CUDA variant"):
            tgk.gmm_bf16_cuda(ta.float().bfloat16(), tb.float().bfloat16(),
                              gs, **tile)
    before = tgk.gmm_cuda.launches
    tgk.gmm(ta, tsa, tb, tsb, gs)
    assert tgk.gmm_cuda.launches == before


def _jcfg(**kw):
    return JConfig(backend="pallas_interpret", **kw)


@pytest.mark.parametrize("layer", ["grouped", "fused", "dense", "dense_fused"])
def test_fp8_linear_layers_match_jax(layer):
    rng = np.random.default_rng(4)
    sizes = [20, 0, 37, 11]
    m, k, n = 80, 256, 384
    x = rng.standard_normal((m, k)).astype(np.float32)
    u = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5).astype(np.float32)
    jx, ju = jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)
    tx, tu, tw = (tensor_from_numpy(np.asarray(v)) for v in (jx, ju, jw))
    jgs = jnp.array(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    cfg = KernelConfig(block_m=16)
    # the JAX layers run jitted, as inside the reference's model: XLA then
    # computes every quantization scale as amax * f32(1/448), like the port
    with events.capture() as evs, torch.inference_mode():
        if layer == "grouped":
            want = jax.jit(lambda x, w, gs: jgg.grouped_linear(
                x, w, gs, precision="fp8", config=_jcfg(block_m=16)))(jx, jw, jgs)
            got = tgg.grouped_linear(tx, tw, tgs, precision="fp8", config=cfg)
        elif layer == "fused":
            want = jax.jit(lambda x, u, w, gs: jgg.grouped_linear_fused(
                x, u, w, gs, config=_jcfg(block_m=16)))(jx, ju, jw, jgs)
            got = tgg.grouped_linear_fused(tx, tu, tw, tgs, config=cfg)
        elif layer == "dense":
            want = jax.jit(lambda x, w: jgg.dense_linear_fp8(
                x, w, config=_jcfg(), out_dtype=jnp.float32))(jx, jw[0])
            got = tgg.dense_linear_fp8(tx, tw[0], out_dtype=torch.float32)
        else:
            want = jax.jit(lambda x, u, w: jgg.dense_linear_fp8_fused(
                x, u, w, config=_jcfg(), out_dtype=jnp.float32))(jx, ju, jw[0])
            got = tgg.dense_linear_fp8_fused(tx, tu, tw[0],
                                             out_dtype=torch.float32)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if layer.startswith("dense")
                         else torch.bfloat16)
    if layer in ("grouped", "fused"):
        assert (got[sum(sizes):] == 0).all()
    if layer in ("grouped", "dense"):
        # quantizer and GEMM inputs are bitwise: one bf16 step
        assert_close_bf16(got.float().numpy(), want)
        assert events.count(evs, "plan_build") == 1
        assert events.count(evs, "quantize_tilewise") == 1
    else:
        # the fused epilogue may sit one e4m3 step off on a few elements,
        # moving a dot product by a few e4m3 steps of one term
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("layer", ["ffn", "ffn_gelu", "dense_ffn", "bf16",
                                   "bf16_f32"])
def test_ffn_and_bf16_layers_match_jax(layer):
    """The producer-fused FFN (its gate/up GEMMs store fp8, the activation
    dequantizes on load) and the bf16 grouped linear against the JAX
    package's, forward.  The JAX bf16 layer runs XLA's ragged dot on the
    CPU, the port the bf16 grouped GEMM's plain version: each output is
    one f32 sum per element, so they agree to one bf16 step."""
    rng = np.random.default_rng(6)
    sizes = [20, 0, 37, 11]
    m, k, f, n = 80, 256, 384, 256
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w1 = jnp.asarray(rng.standard_normal((4, k, f)) * k ** -0.5, jnp.bfloat16)
    w2 = jnp.asarray(rng.standard_normal((4, k, f)) * k ** -0.5, jnp.bfloat16)
    w3 = jnp.asarray(rng.standard_normal((4, f, n)) * f ** -0.5, jnp.bfloat16)
    tx, tw1, tw2, tw3 = (tensor_from_numpy(np.asarray(v))
                         for v in (x, w1, w2, w3))
    jgs = jnp.array(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    cfg = KernelConfig(block_m=16)
    with events.capture() as evs, torch.inference_mode():
        if layer == "ffn":
            want = jax.jit(lambda *a: jgg.grouped_linear_ffn(
                *a, jgs, config=_jcfg(block_m=16)))(x, w1, w2, w3)
            got = tgg.grouped_linear_ffn(tx, tw1, tw2, tw3, tgs, config=cfg)
        elif layer == "ffn_gelu":
            # unary: w_up is the single projection
            want = jax.jit(lambda x, w, wd: jgg.grouped_linear_ffn(
                x, None, w, wd, jgs, act="gelu",
                config=_jcfg(block_m=16)))(x, w2, w3)
            got = tgg.grouped_linear_ffn(tx, None, tw2, tw3, tgs, act="gelu",
                                         config=cfg)
        elif layer == "dense_ffn":
            want = jax.jit(lambda *a: jgg.dense_ffn_fp8(
                *a, config=_jcfg(), out_dtype=jnp.float32))(
                    x, w1[0], w2[0], w3[0])
            got = tgg.dense_ffn_fp8(tx, tw1[0], tw2[0], tw3[0],
                                    out_dtype=torch.float32)
        else:
            out = jnp.float32 if layer == "bf16_f32" else None
            want = jax.jit(lambda x, w: jgg.grouped_linear(
                x, w, jgs, precision="bf16", out_dtype=out))(x, w1)
            got = tgg.grouped_linear(
                tx, tw1, tgs, precision="bf16", config=cfg,
                out_dtype=None if out is None else torch.float32)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if layer in ("dense_ffn", "bf16_f32")
                         else torch.bfloat16)
    if layer != "dense_ffn":
        assert (got[sum(sizes):] == 0).all()
    if layer.startswith("bf16"):
        assert_close_bf16(got.float().numpy(), want)
        assert events.count(evs, "quantize_tilewise") == 0
    else:
        # the FFN quantizes x once; its fused epilogue may sit one e4m3
        # step off on a few elements of h, as grouped_linear_fused's
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err
        assert events.count(evs, "quantize_tilewise") == 1
    assert events.count(evs, "plan_build") == 1


def test_bf16_precision_argument_checks():
    x = torch.zeros((8, 128))
    w = torch.zeros((1, 128, 128))
    gs = torch.tensor([8], dtype=torch.int32)
    from repro_torch.core.quantization import quantize_activation
    with pytest.raises(ValueError, match="never quantizes"):
        tgg.grouped_linear(x, w, gs, precision="bf16",
                           quantized=quantize_activation(x))
    with pytest.raises(ValueError, match="wgrad_precision='fp8'"):
        tgg.grouped_linear(x, w, gs, precision="bf16",
                           config=KernelConfig(wgrad_precision="fp8"))
    with pytest.raises(ValueError, match="unknown precision"):
        tgg.grouped_linear(x, w, gs, precision="int4")
    with pytest.raises(ValueError, match="needs both w_gate and w_up"):
        tgg.grouped_linear_ffn(x, None, w, w, gs)
    with pytest.raises(ValueError, match="unary"):
        tgg.grouped_linear_ffn(x, w, w, w, gs, act="gelu")
