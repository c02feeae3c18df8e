"""The port's wgrad (``dw[g] = x_g^T dy_g`` over a ragged M) against the
JAX package's Pallas kernels ``gmm_pallas_wgrad`` / ``gmm_pallas_wgrad_fp8``
(interpret mode on the CPU) and its exact one-hot oracles.

All of them accumulate exact f32 products of the same operands in f32, in
different orders: the tolerance is 1e-5 of the largest |dw|.  A bf16 dw is
that f32 sum rounded once to nearest: bitwise the f32 dw cast to bf16, and
within one bf16 step of the reference's bf16 dw (the two f32 sums may
round to neighbouring bf16 values).  Structural
zeros (empty groups, the all-empty call) must be exactly zero, and rows
past ``sum(group_sizes)`` must not reach the result even when they hold
NaN.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import dispatch
from repro.kernels import ref as jref
from repro.kernels.wgrad_kernel import gmm_pallas_wgrad, gmm_pallas_wgrad_fp8
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wgrad_kernel as twk
from repro_torch.kernels.plan import make_tile_plan

TOL = 1e-5
FP8_DTYPE = torch.float8_e4m3fn

# name: (group sizes, M, K, N, block_m)
CASES = {
    "ragged": ([100, 0, 37, 63], 200, 256, 128, 128),
    "ragged_bm16": ([5, 40, 0, 3, 17], 65, 128, 256, 16),
    "tail": ([30, 20], 96, 128, 128, 16),                # sum < M
    "mid_chunk": ([1, 1, 130, 1], 133, 128, 128, 128),   # starts off-tile
    "all_empty": ([0, 0, 0], 64, 128, 128, 16),
}


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * scale, (err, scale)


def _bf16_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
    return (x, dy), (tensor_from_numpy(np.asarray(x)),
                     tensor_from_numpy(np.asarray(dy)))


def _fp8_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    dy = (rng.standard_normal((m, n)) * 1e-3).astype(np.float32)
    quant = jax.jit(jref.quantize_tilewise_ref)
    j = (*quant(jnp.asarray(x)), *quant(jnp.asarray(dy)))
    return j, tuple(tensor_from_numpy(np.asarray(v)) for v in j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_wgrad_matches_pallas_and_oracle(case):
    sizes, m, k, n, bm = CASES[case]
    (jx, jdy), (tx, tdy) = _bf16_operands(m, k, n, seed=m + k)
    jgs = jnp.asarray(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    pallas = gmm_pallas_wgrad(jx, jdy, jgs, block_m=bm, interpret=True)
    oracle = dispatch.wgrad_xla_exact(jx, jdy, jgs, num_groups=len(sizes))
    got = twk.gmm_wgrad(tx, tdy, tgs, block_m=bm)
    assert got.dtype == torch.float32 and got.shape == (len(sizes), k, n)
    _close(got.numpy(), pallas)
    _close(got.numpy(), oracle)
    _close(tref.wgrad_exact_ref(tx, tdy, tgs).numpy(), oracle)
    for g, s in enumerate(sizes):
        if s == 0:
            assert (got[g] == 0).all()
    # the forward's plan gives the same result as the group sizes alone
    plan = make_tile_plan(tgs, m, block_m=bm)
    assert torch.equal(twk.gmm_wgrad(tx, tdy, tgs, plan=plan), got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_wgrad_bf16_out_matches_pallas(case):
    sizes, m, k, n, bm = CASES[case]
    (jx, jdy), (tx, tdy) = _bf16_operands(m, k, n, seed=m + k)
    jgs = jnp.asarray(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    pallas = gmm_pallas_wgrad(jx, jdy, jgs, block_m=bm,
                              out_dtype=jnp.bfloat16, interpret=True)
    got = twk.gmm_wgrad_plain(tx, tdy, tgs, block_m=bm,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (len(sizes), k, n)
    f32 = twk.gmm_wgrad_plain(tx, tdy, tgs, block_m=bm)
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = np.asarray(pallas.astype(jnp.float32))
    step = np.abs(want) * 2.0 ** -7 + TOL * max(float(np.abs(want).max()),
                                                 1e-30)
    assert (np.abs(got.float().numpy() - want) <= step).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_wgrad_fp8_matches_pallas_and_oracle(case):
    sizes, m, k, n, bm = CASES[case]
    j, t = _fp8_operands(m, k, n, seed=m + n)
    jgs = jnp.asarray(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    pallas = gmm_pallas_wgrad_fp8(*j, jgs, block_m=bm, interpret=True)
    oracle = dispatch.wgrad_fp8_xla_exact(*j, jgs, num_groups=len(sizes))
    got = twk.gmm_wgrad_fp8(*t, tgs, block_m=bm)
    assert got.dtype == torch.float32 and got.shape == (len(sizes), k, n)
    _close(got.numpy(), pallas)
    _close(got.numpy(), oracle)
    _close(tref.wgrad_fp8_exact_ref(*t, tgs).numpy(), oracle)
    for g, s in enumerate(sizes):
        if s == 0:
            assert (got[g] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_wgrad_fp8_bf16_out_matches_pallas(case):
    """The fp8 wgrad with dw in bf16, as the training path takes it: the
    f32 sum rounded once, within one bf16 step of the reference's bf16 dw;
    empty groups exactly zero."""
    sizes, m, k, n, bm = CASES[case]
    j, t = _fp8_operands(m, k, n, seed=m + n)
    jgs = jnp.asarray(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    pallas = gmm_pallas_wgrad_fp8(*j, jgs, block_m=bm,
                                  out_dtype=jnp.bfloat16, interpret=True)
    got = twk.gmm_wgrad_fp8(*t, tgs, block_m=bm, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (len(sizes), k, n)
    f32 = twk.gmm_wgrad_fp8(*t, tgs, block_m=bm)
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = np.asarray(pallas.astype(jnp.float32))
    step = np.abs(want) * 2.0 ** -7 + TOL * max(float(np.abs(want).max()),
                                                 1e-30)
    assert (np.abs(got.float().numpy() - want) <= step).all()
    for g, s in enumerate(sizes):
        if s == 0:
            assert (got[g] == 0).all()


def test_fp8_cuda_refuses_other_out_dtypes_before_the_device():
    """The fp8 kernel writes dw in f32 or bf16 only: any other dtype is a
    TypeError, raised before the operands' device is looked at."""
    x = torch.randn(16, 128)
    q8, s = tref.quantize_tilewise_ref(x)
    gs = torch.tensor([16], dtype=torch.int32)
    before = twk.gmm_wgrad_fp8_cuda.launches
    for dt in (torch.float16, torch.float64, FP8_DTYPE):
        with pytest.raises(TypeError, match="writes dw in"):
            twk.gmm_wgrad_fp8_cuda(q8, s, q8, s, gs, out_dtype=dt)
    assert twk.gmm_wgrad_fp8_cuda.launches == before
    assert twk.WGRAD_OUT_DTYPES == (torch.float32, torch.bfloat16)


def test_nan_tail_is_excluded():
    """Rows past sum(group_sizes) hold NaN: the Pallas kernels mask them
    out, and the port's wgrad never reads them."""
    sizes, m, k, n = [20, 0, 31], 80, 128, 256
    (jx, jdy), _ = _bf16_operands(m, k, n, seed=5)
    total = sum(sizes)
    jx = jx.at[total:].set(jnp.nan)
    jdy = jdy.at[total:].set(jnp.nan)
    tx, tdy = (tensor_from_numpy(np.asarray(v)) for v in (jx, jdy))
    jgs = jnp.asarray(sizes, jnp.int32)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    got = twk.gmm_wgrad(tx, tdy, tgs)
    assert torch.isfinite(got).all()
    _close(got.numpy(), gmm_pallas_wgrad(jx, jdy, jgs, block_m=16,
                                         interpret=True))
    clean = twk.gmm_wgrad(tx[:total], tdy[:total], tgs)
    assert torch.equal(got, clean)

    j, t = _fp8_operands(m, k, n, seed=6)
    t = [v.clone() for v in t]
    for v in t:
        if v.dtype == torch.float32:
            v[total:] = float("nan")
        else:
            v.view(torch.uint8)[total:] = 0x7F       # e4m3 NaN
    got8 = twk.gmm_wgrad_fp8(*t, tgs)
    assert torch.isfinite(got8).all()
    assert torch.equal(got8, twk.gmm_wgrad_fp8(*(v[:total] for v in t), tgs))


def test_empty_buffer_and_argument_checks():
    x = torch.zeros((0, 128), dtype=torch.bfloat16)
    dy = torch.zeros((0, 256), dtype=torch.bfloat16)
    got = twk.gmm_wgrad(x, dy, torch.zeros(3, dtype=torch.int32))
    assert got.shape == (3, 128, 256) and (got == 0).all()
    x = torch.randn(16, 128).bfloat16()
    dy = torch.randn(16, 128).bfloat16()
    gs = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree on M"):
        twk.gmm_wgrad(x, dy[:8], gs)
    with pytest.raises(ValueError, match="multiple"):
        twk.gmm_wgrad(x[:, :96], dy, gs)
    plan = make_tile_plan(gs, 32, block_m=16)
    with pytest.raises(ValueError, match="TilePlan built for"):
        twk.gmm_wgrad(x, dy, gs, plan=plan)
    q8, s = tref.quantize_tilewise_ref(x.float())
    with pytest.raises(ValueError, match="s_x"):
        twk.gmm_wgrad_fp8(q8, s[:, :0], q8, s, gs)
    # a CPU tensor never reaches a kernel; the CUDA wrappers refuse it
    before = (twk.gmm_wgrad_cuda.launches, twk.gmm_wgrad_fp8_cuda.launches)
    twk.gmm_wgrad(x, dy, gs)
    twk.gmm_wgrad_fp8(q8, s, q8, s, gs)
    assert (twk.gmm_wgrad_cuda.launches,
            twk.gmm_wgrad_fp8_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        twk.gmm_wgrad_cuda(x, dy, gs)
    # the bf16 kernel writes f32 or bf16 only: checked before the device
    with pytest.raises(TypeError, match="writes dw in"):
        twk.gmm_wgrad_cuda(x, dy, gs, out_dtype=torch.float16)
    assert twk.gmm_wgrad_cuda.launches == before[0]
    with pytest.raises(ValueError, match="CUDA"):
        twk.gmm_wgrad_fp8_cuda(q8, s, q8, s, gs)
