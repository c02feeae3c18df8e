"""The port's plain bf16 grouped GEMM (B5) against the JAX package's Pallas
kernel ``gmm_pallas_bf16`` (interpret mode on the CPU) and its
reduction-order oracle ``gmm_bf16_xla_exact``.

Both sum each 128-K block in f32, in another order inside the block: a
bf16 output is held within one bf16 step (2^-7 of the value) plus 1e-4
of the largest output, an f32 output within 1e-5 of the largest output.
Rows >= sum(group_sizes) must be exactly zero.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.dispatch import gmm_bf16_xla_exact
from repro.kernels.grouped_gemm_kernel import gmm_pallas_bf16
from repro_torch.convert import tensor_from_numpy
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
    "single_group": (40, 256, 128, [40], 128),
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


def operands(m, k, n, g, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((g, k, n)) * k ** -0.5, jnp.bfloat16)
    return (x, w), (tensor_from_numpy(np.asarray(x)),
                    tensor_from_numpy(np.asarray(w)))


def max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else 0.0


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gmm_bf16_matches_pallas(case, out):
    m, k, n, sizes, bm, bn = geometry(case)
    (jx, jw), (tx, tw) = operands(m, k, n, len(sizes), 0)
    jgs = jnp.array(sizes, jnp.int32)
    want = gmm_pallas_bf16(jx, jw, jgs, block_m=bm, block_n=bn,
                           interpret=True, out_dtype=getattr(jnp, out))
    want = np.asarray(want.astype(jnp.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = tgk.gmm_bf16(tx, tw, gs, block_m=bm, block_n=bn,
                       out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    total = sum(sizes)
    assert (got[total:] == 0).all() and np.all(want[total:] == 0)
    got = got.float().numpy()
    if out == "bfloat16":
        tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max() + 1e-30
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    else:
        assert max_rel(got, want) <= 1e-5
    # the plain version is the port's copy of the reduction-order oracle
    oracle = jax.jit(gmm_bf16_xla_exact, static_argnames="out_dtype")(
        jx, jw, jgs, out_dtype=jnp.float32)
    assert max_rel(tref.gmm_bf16_exact_ref(tx, tw, gs, out_dtype=torch.float32)
                   .numpy(), np.asarray(oracle)) <= 1e-6


def test_gmm_bf16_plan_out_and_empty_buffer():
    m, k, n, sizes, bm = CASES["ragged_tail"]
    _, (tx, tw) = operands(m, k, n, len(sizes), 1)
    gs = torch.tensor(sizes, dtype=torch.int32)
    plan = make_tile_plan(gs, m, block_m=bm)
    out = torch.full((m, n), float("nan"))
    got = tgk.gmm_bf16(tx, tw, gs, block_m=bm, plan=plan,
                       out_dtype=torch.float32, out=out)
    assert got is out and not torch.isnan(out).any()
    np.testing.assert_array_equal(
        out.bfloat16().float().numpy(),
        tgk.gmm_bf16(tx, tw, gs, block_m=bm).float().numpy())
    # an empty buffer gives an empty result
    z = tgk.gmm_bf16(tx[:0], tw, torch.zeros(4, dtype=torch.int32))
    assert z.shape == (0, n) and z.dtype == torch.bfloat16


def test_gmm_bf16_argument_checks():
    _, (tx, tw) = operands(32, 256, 256, 2, 2)
    gs = torch.tensor([16, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree on K"):
        tgk.gmm_bf16(tx[:, :128].contiguous(), tw, gs)
    with pytest.raises(ValueError, match="multiple of block_n"):
        tgk.gmm_bf16(tx, tw[:, :, :100].contiguous(), gs)
    plan = make_tile_plan(gs, 32, block_m=16)
    with pytest.raises(ValueError, match="TilePlan built for"):
        tgk.gmm_bf16(tx, tw, gs, block_m=128, plan=plan)
    # a CPU tensor takes the plain version; the CUDA wrapper refuses it
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gmm_bf16_cuda(tx, tw, gs)
    before = tgk.gmm_bf16_cuda.launches
    tgk.gmm_bf16(tx, tw, gs)
    assert tgk.gmm_bf16_cuda.launches == before


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["ragged_tail", "ragged_bm16"])
def test_plain_gmm_bf16_on_transposed_weight_matches_pallas(case, out):
    """The dgrad's operand: ``w^T`` handed over as ``transpose(1, 2)`` of
    the weight's own [G, N, K] storage, never copied.  Same inputs and
    tolerances as the N-contiguous case."""
    m, k, n, sizes, bm = CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_nk = (rng.standard_normal((len(sizes), n, k)) * k ** -0.5) \
        .astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w_nk.transpose(0, 2, 1), jnp.bfloat16)
    jgs = jnp.array(sizes, jnp.int32)
    want = gmm_pallas_bf16(jx, jw, jgs, block_m=bm, interpret=True,
                           out_dtype=getattr(jnp, out))
    want = np.asarray(want.astype(jnp.float32))
    tx = tensor_from_numpy(np.asarray(jx))
    storage = tensor_from_numpy(np.asarray(jnp.asarray(w_nk, jnp.bfloat16)))
    tw = storage.transpose(1, 2)
    assert tgk.weight_layout(tw) == 1 and tw.data_ptr() == storage.data_ptr()
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = tgk.gmm_bf16(tx, tw, gs, block_m=bm, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (m, n)
    total = sum(sizes)
    assert (got[total:] == 0).all()
    got = got.float().numpy()
    if out == "bfloat16":
        tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max() + 1e-30
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    else:
        assert max_rel(got, want) <= 1e-5


def test_weight_layout_accepts_two_layouts_and_refuses_others():
    """The CUDA kernel reads B N-contiguous (0) or K-contiguous (1); the
    wrapper raises on any other strides rather than copying."""
    w = torch.zeros(3, 256, 384, dtype=torch.bfloat16)
    assert tgk.weight_layout(w) == 0
    assert tgk.weight_layout(
        torch.zeros(3, 384, 256, dtype=torch.bfloat16).transpose(1, 2)) == 1
    # a single group (the group stride is free), at an offset
    assert tgk.weight_layout(w[1:2]) == 0
    assert tgk.weight_layout(
        torch.zeros(384, 256, dtype=torch.bfloat16)[None].transpose(1, 2)) == 1
    wide = torch.zeros(3, 256, 768, dtype=torch.bfloat16)
    for bad in (wide[:, :, :384], w.transpose(0, 1), wide[:, :, ::2],
                torch.zeros(3, 384, 512, dtype=torch.bfloat16)
                .transpose(1, 2)[:, :256]):
        with pytest.raises(ValueError, match="strides"):
            tgk.weight_layout(bad)
