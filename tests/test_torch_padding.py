"""The port's padded baseline (``core/padding_baseline.py``,
``KernelConfig.backend="padded_baseline"``) against the JAX package's, on
the CPU, and against the port's own padding-free path.

The JAX package's baseline runs its inner GEMM on the Pallas kernel in
interpret mode, as its own tests run it; the port runs the plain version
of B2.  Tolerances, each with its reason:
  - the pad pass's padded sizes, row map and padded buffers, and the
    overhead bytes: bit for bit (integer schedules and copies of fp8
    bytes and f32 scales);
  - the padded GEMM against the JAX package's: one bf16 step (2^-7 of the
    value) plus 1e-4 of the largest output, the GEMM tolerance of
    ``tests/test_torch_grouped_gemm.py`` (each 128-K block summed in f32
    in another order);
  - padded against padding-free inside the port: bitwise on every owned
    row, the paper's equivalence claim (``BENCH_2026-08-08.json``,
    ``equivalence/*``);
  - the layers and their gradients against the JAX package's: the bounds
    of ``tests/test_torch_grouped_gemm.py`` and
    ``tests/test_torch_train.py`` (2% of the largest element).
"""
import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from benchmarks.common import generate_group_sizes
from repro.core import grouped_gemm as jgg
from repro.core import padding_baseline as jpb
from repro.kernels import ref as jref
from repro.kernels.plan import KernelConfig as JConfig
from repro_torch.analysis import events
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import grouped_gemm as tgg
from repro_torch.core import padding_baseline as tpb
from repro_torch.kernels import grouped_gemm_kernel as tgk
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.plan import KernelConfig, make_tile_plan

PADDED = "padded_baseline"


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_to_max(got, want):
    got = got.detach().float().numpy()
    want = _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = np.abs(want) * 2.0 ** -7 + 1e-4 * np.abs(want).max() + 1e-30
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


def operands(m, k, n, g, seed):
    """The same e4m3 operands and scales in both packages: A quantized
    1x128, B 128x128, by the JAX package (jitted) and carried over."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((g, k, n)) * k ** -0.5).astype(np.float32)
    ja, jsa = jax.jit(jref.quantize_tilewise_ref)(jnp.asarray(a))
    jb, jsb = jax.jit(jax.vmap(jref.quantize_blockwise_ref))(jnp.asarray(w))
    t = [tensor_from_numpy(np.asarray(v)) for v in (ja, jsa, jb, jsb)]
    return (ja, jsa, jb, jsb), t


PAD_CASES = {
    # name: (M, K, group sizes, block_m, padded_m)
    "ragged_empty_tail": (100, 256, [30, 0, 50, 7], 128, None),
    "exact_tiles": (384, 128, [128, 0, 256], 128, None),
    "all_empty": (48, 128, [0, 0, 0], 16, None),
    "bm16_spans": (70, 256, [0, 16, 1, 33, 0, 20], 16, None),
    "last_group_empty": (90, 128, [40, 50, 0], 128, None),
    "explicit_bound": (256, 128, [60, 0, 130], 128, 640),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_groups_matches_jax(case):
    """``pad_groups``' padded sizes, row map and padded A / S_A bit for bit
    against the JAX package's, empty groups, groups of whole tiles, an
    all-empty plan, rows past the data and the default ``padded_m``
    included."""
    m, k, sizes, bm, padded_m = PAD_CASES[case]
    (ja, jsa, _, _), (ta, tsa, _, _) = operands(m, k, 128, len(sizes), 0)
    want = jpb.pad_groups(ja, jsa, jnp.asarray(sizes, jnp.int32),
                          block_m=bm, padded_m=padded_m)
    tgs = torch.tensor(sizes, dtype=torch.int32)
    got = tpb.pad_groups(ta, tsa, tgs, block_m=bm, padded_m=padded_m)
    a_p, s_p, psz, row_map = got
    assert a_p.dtype == ta.dtype and a_p.is_contiguous()
    assert s_p.dtype == torch.float32 and s_p.is_contiguous()
    assert psz.dtype == torch.int32 and row_map.dtype == torch.int32
    np.testing.assert_array_equal(psz.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(row_map.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(
        a_p.view(torch.uint8).numpy(),
        np.asarray(want[0]).view(np.uint8))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(want[1]))
    if padded_m is None:
        g = len(sizes)
        assert a_p.shape[0] == tpb.default_padded_m(m, g, bm) == \
            int(np.ceil((m + g * (bm - 1)) / bm) * bm)
    np.testing.assert_array_equal(
        tpb.padded_group_sizes(tgs, bm).numpy(),
        np.asarray(jpb.padded_group_sizes(jnp.asarray(sizes), bm)))


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_unpad_round_trip(case):
    """unpad(pad(x)) gives every row back; the padded buffer holds each
    group at a block-aligned offset and zeros (scales 1) elsewhere."""
    m, k, sizes, bm, padded_m = PAD_CASES[case]
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((m, k), generator=gen)
    s = torch.rand((m, k // 128), generator=gen) + 0.5
    tgs = torch.tensor(sizes, dtype=torch.int32)
    x_p, s_p, psz, row_map = tpb.pad_groups(x, s, tgs, block_m=bm,
                                            padded_m=padded_m)
    assert torch.equal(tpb.unpad_groups(x_p, row_map), x)
    assert torch.equal(tpb.unpad_groups(s_p, row_map), s)
    assert ((psz % bm) == 0).all() and (psz >= tgs).all()
    assert bool(((psz == 0) == (tgs == 0)).all())
    used = torch.zeros(x_p.shape[0], dtype=torch.bool)
    used[row_map.long()] = True
    assert (x_p[~used] == 0).all() and (s_p[~used] == 1).all()
    starts = torch.cumsum(psz, 0) - psz
    total = sum(sizes)
    for g, (st, n) in enumerate(zip(starts.tolist(), sizes)):
        src = sum(sizes[:g])
        assert torch.equal(row_map[src:src + n],
                           torch.arange(st, st + n, dtype=torch.int32))
    assert (row_map[total:] >= 0).all()


def test_pad_pass_reads_nothing_back():
    """The pad pass and the padded plan are tensor ops on the sizes'
    device: no ``item``/``tolist``/``int`` read of a tensor, so on the
    card they never wait for it."""
    (_, _, _, _), (ta, tsa, _, _) = operands(100, 256, 128, 4, 0)
    tgs = torch.tensor([30, 0, 50, 7], dtype=torch.int32)

    def boom(*_a, **_k):
        raise AssertionError("host read of a tensor")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "__int__", "__bool__", "__index__"):
            mp.setattr(torch.Tensor, name, boom)
        a_p, _, psz, row_map = tpb.pad_groups(ta, tsa, tgs)
        make_tile_plan(psz, a_p.shape[0], block_m=128, num_groups=4)
        tpb.unpad_groups(torch.zeros((a_p.shape[0], 8)), row_map)


@pytest.mark.parametrize("sizes,k,bm", [([30, 0, 50, 7], 256, 128),
                                        ([0, 0, 0], 128, 16),
                                        ([128, 1, 127], 128, 16)])
def test_padding_overhead_bytes_matches_jax(sizes, k, bm):
    want = jpb.padding_overhead_bytes(sizes, k, k // 128, block_m=bm)
    assert tpb.padding_overhead_bytes(sizes, k, k // 128, block_m=bm) == want
    assert tpb.padding_overhead_bytes(torch.tensor(sizes), k, k // 128,
                                      block_m=bm) == want


GEMM_CASES = {
    # name: (M, K, N, group sizes, block_m)
    "ragged_tail": (100, 256, 384, [30, 0, 50, 7], 128),
    "bm16": (70, 256, 256, [0, 16, 1, 33, 0, 20], 16),
    "decode_bm16": (16, 384, 256, [0, 3, 0, 0, 9, 4, 0, 0], 16),
    "all_empty": (48, 128, 256, [0, 0, 0], 16),
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_padded_gemm_matches_jax(case):
    """``grouped_gemm_fp8_padded`` (the plain B2 over the padded buffer)
    against the JAX package's (its Pallas kernel in interpret mode) at
    the GEMM tolerance; tail rows as the JAX package leaves them."""
    m, k, n, sizes, bm = GEMM_CASES[case]
    (ja, jsa, jb, jsb), (ta, tsa, tb, tsb) = operands(m, k, n, len(sizes), 1)
    want = jpb.grouped_gemm_fp8_padded(
        ja, jsa, jb, jsb, jnp.asarray(sizes, jnp.int32),
        config=JConfig(block_m=bm), backend="pallas_interpret",
        out_dtype=jnp.bfloat16)
    got = tpb.grouped_gemm_fp8_padded(
        ta, tsa, tb, tsb, torch.tensor(sizes, dtype=torch.int32),
        config=KernelConfig(block_m=bm))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_close_bf16(got.float().numpy(), _np(want))


@pytest.mark.parametrize("m,g", [(512, 4), (1024, 8), (768, 16)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_padded_equals_padding_free_bitwise(m, g, out_dtype):
    """The paper's equivalence claim inside the port, at the JAX
    package's ``equivalence/*`` shapes and group sizes: the padded
    pipeline equals the padding-free GEMM bit for bit on every row."""
    sizes = generate_group_sizes(m, g, seed=g)
    (_, _, _, _), (ta, tsa, tb, tsb) = operands(m, 256, 256, g, g)
    tgs = torch.from_numpy(sizes)
    ours = tgk.gmm(ta, tsa, tb, tsb, tgs, out_dtype=out_dtype)
    base = tpb.grouped_gemm_fp8_padded(ta, tsa, tb, tsb, tgs,
                                       out_dtype=out_dtype)
    assert torch.equal(ours, base)


def _layer_inputs(seed=7, m=80, k=256, n=384, g=4):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    u = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((g, k, n)) * k ** -0.5, jnp.bfloat16)
    w2 = jnp.asarray(rng.standard_normal((g, k, n)) * k ** -0.5,
                     jnp.bfloat16)
    w3 = jnp.asarray(rng.standard_normal((g, n, k)) * n ** -0.5,
                     jnp.bfloat16)
    return x, u, w, w2, w3


SIZES = [20, 0, 37, 23]          # the layers' rows: M = 80, no tail


@pytest.mark.parametrize("wgrad", ["bf16", "fp8"])
@pytest.mark.parametrize("layer", ["grouped", "dense", "gemm_quant",
                                   "fused"])
def test_padded_layers_and_grads_match_jax(layer, wgrad):
    """The grouped, dense (G=1), quantizing (the producer-fused FFN, whose
    gate/up GEMMs are ``gemm_quant``) and fused-epilogue layers under
    ``backend="padded_baseline"``, forward and every gradient, against
    the JAX package's under the same backend (its padded GEMM on the
    Pallas kernel in interpret mode, its wgrad auto-resolved), within 2%
    of the largest element.  Each padded GEMM plans over its padded sizes
    through the plan cache and the layer builds no plan: every GEMM of
    the layer, forward and dgrad, has the same static padded shape, so
    one ``plan_build`` in all, in the forward."""
    x, u, w, w2, w3 = _layer_inputs()
    dense = layer == "dense"
    jgs = jnp.asarray(SIZES, jnp.int32)
    tgs = torch.tensor(SIZES, dtype=torch.int32)
    jcfg = JConfig(backend=PADDED, block_m=16, wgrad_precision=wgrad)
    cfg = KernelConfig(backend=PADDED, block_m=16, wgrad_precision=wgrad)
    if layer == "grouped":
        f = lambda x, w: jgg.grouped_linear(x, w, jgs, precision="fp8",
                                            config=jcfg)
        args = (x, w)
    elif dense:
        f = lambda x, w: jgg.dense_linear_fp8(x, w, config=jcfg)
        args = (x, w[0])
    elif layer == "gemm_quant":
        f = lambda x, wg, wu, wd: jgg.grouped_linear_ffn(x, wg, wu, wd, jgs,
                                                         config=jcfg)
        args = (x, w, w2, w3)
    else:
        f = lambda x, u, w: jgg.grouped_linear_fused(x, u, w, jgs,
                                                     config=jcfg)
        args = (x, u, w)
    dy = jnp.asarray(np.random.default_rng(8).standard_normal(
        jax.eval_shape(f, *args).shape), jnp.bfloat16)

    @jax.jit
    def jax_vjp(*a):
        y, vjp = jax.vjp(f, *a)
        return y, vjp(dy)
    want_y, want_grads = jax_vjp(*args)

    targs = [tensor_from_numpy(np.asarray(a)).requires_grad_() for a in args]
    tplan.PLAN_CACHE.clear()
    with events.capture() as evs:
        if layer == "grouped":
            y = tgg.grouped_linear(*targs, tgs, precision="fp8", config=cfg)
        elif dense:
            y = tgg.dense_linear_fp8(*targs, config=cfg)
        elif layer == "gemm_quant":
            y = tgg.grouped_linear_ffn(*targs, tgs, config=cfg)
        else:
            y = tgg.grouped_linear_fused(*targs, tgs, config=cfg)
        n_fwd = events.count(evs, "plan_build")
        y.backward(tensor_from_numpy(np.asarray(dy)))
    # the forward's padded GEMMs (the FFN's gate, up and down) and the
    # dgrads share one static padded shape: one build, then replays
    assert n_fwd == 1
    assert events.count(evs, "plan_build") == 1
    assert tplan.PLAN_CACHE.builds == 1
    assert rel_to_max(y, want_y) <= 2e-2
    for t, want in zip(targs, want_grads):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        assert rel_to_max(t.grad, want) <= 2e-2, rel_to_max(t.grad, want)


@pytest.mark.parametrize("layer", ["grouped", "gemm_quant", "fused", "dense"])
def test_padded_layers_equal_padding_free(layer):
    """Inside the port the padded layers equal the padding-free ones bit
    for bit, forward and backward: only the GEMM's padding differs."""
    x, u, w, w2, w3 = _layer_inputs(seed=9)
    tgs = torch.tensor(SIZES, dtype=torch.int32)
    dy = torch.randn((80, 256 if layer == "gemm_quant" else 384),
                     generator=torch.Generator().manual_seed(1)
                     ).bfloat16()
    outs = []
    for backend in (None, PADDED):
        cfg = KernelConfig(backend=backend, block_m=16)
        if layer == "fused":
            args = [tensor_from_numpy(np.asarray(a)).requires_grad_()
                    for a in (x, u, w)]
            y = tgg.grouped_linear_fused(*args, tgs, config=cfg)
        elif layer == "gemm_quant":
            args = [tensor_from_numpy(np.asarray(a)).requires_grad_()
                    for a in (x, w, w2, w3)]
            y = tgg.grouped_linear_ffn(*args, tgs, config=cfg)
        elif layer == "dense":
            args = [tensor_from_numpy(np.asarray(a)).requires_grad_()
                    for a in (x, w[0])]
            y = tgg.dense_linear_fp8(*args, config=cfg)
        else:
            args = [tensor_from_numpy(np.asarray(a)).requires_grad_()
                    for a in (x, w)]
            y = tgg.grouped_linear(*args, tgs, precision="fp8", config=cfg)
        y.backward(dy)
        outs.append([y.detach()] + [a.grad for a in args])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp8", "bf16"])
def test_moe_layer_under_the_baseline(precision):
    """``MoEConfig.backend="padded_baseline"``: the fp8 layer builds no
    plan of its own (its padded GEMMs plan through the plan cache: one
    build for the routed gate, up and down, one for the shared experts')
    and equals the padding-free layer bit for bit, forward and backward;
    the bf16 layer ignores the backend."""
    from repro_torch.core import moe as tmoe
    cfg = tmoe.MoEConfig(num_experts=8, top_k=2, d_model=256,
                         d_ff_expert=128, num_shared_experts=1,
                         precision=precision,
                         kernel_config=KernelConfig(block_m=16))
    gen = torch.Generator().manual_seed(4)
    params = tmoe.init_moe_params(cfg, generator=gen, device="cpu",
                                  dtype=torch.bfloat16)
    x = torch.randn((24, 256), generator=gen).bfloat16()
    out, plans = [], []
    for backend in (None, PADDED):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        tx = x.clone().requires_grad_()
        tplan.PLAN_CACHE.clear()
        with events.capture() as evs, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            y, _ = tmoe.moe_apply(p, tx, dataclasses.replace(
                cfg, backend=backend))
            plans.append(events.count(evs, "plan_build"))
        y.float().sum().backward()
        out.append([y.detach(), tx.grad] + [p[k].grad for k in sorted(p)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert plans == ([2, 2] if precision == "fp8" else [1, 1])


def test_gemm_quant_under_the_baseline_is_the_quantized_padded_gemm():
    """The quantizing GEMM under the baseline is the padded GEMM, then
    the tilewise quantizer: bitwise what the quantizing GEMM stores."""
    (_, _, _, _), (ta, tsa, _, _) = operands(80, 256, 384, 4, 3)
    tgs = torch.tensor(SIZES, dtype=torch.int32)
    w = (torch.randn((4, 256, 384), generator=torch.Generator()
                     .manual_seed(3)) * 256 ** -0.5).bfloat16()
    cfg = KernelConfig(block_m=16)
    q_free = tgg._gemm_quant(ta, tsa, w, tgs, cfg,
                             make_tile_plan(tgs, 80, block_m=16),
                             torch.bfloat16)
    q_pad = tgg._gemm_quant(ta, tsa, w, tgs, cfg.with_(backend=PADDED),
                            None, torch.bfloat16)
    assert torch.equal(q_free[0].view(torch.uint8),
                       q_pad[0].view(torch.uint8))
    assert torch.equal(q_free[1], q_pad[1])


def test_backend_names():
    """None and "padded_baseline" run; "auto" sets the backend back to
    None; the JAX package's other registry names raise
    ``NotImplementedError`` naming the registry; unknown names
    ``ValueError``; the bf16 path ignores the backend with a warning, as
    the JAX package's does."""
    assert tplan.resolve_config(KernelConfig(backend=PADDED),
                                backend="auto").backend is None
    assert tplan.resolve_config(None, backend=PADDED).backend == PADDED
    assert tplan.resolve_config(KernelConfig(backend=PADDED)).backend == \
        PADDED
    for name in ("pallas", "pallas_interpret", "xla_ragged", "xla_exact",
                 "xla", "ref", "pallas_fp8"):
        with pytest.raises(NotImplementedError, match="registry"):
            KernelConfig(backend=name)
        with pytest.raises(NotImplementedError, match="registry"):
            tplan.resolve_config(None, backend=name)
        with pytest.raises(NotImplementedError, match="registry"):
            ModelConfig(name="x", family="dense", num_layers=1, d_model=128,
                        num_heads=1, num_kv_heads=1, d_ff=128,
                        vocab_size=8, gemm_backend=name)
    with pytest.raises(ValueError, match="unknown backend"):
        KernelConfig(backend="triton")
    x = torch.randn((24, 128)).bfloat16()
    w = (torch.randn((2, 128, 128)) * 0.1).bfloat16()
    gs = torch.tensor([10, 14], dtype=torch.int32)
    with pytest.warns(UserWarning, match="ignores backend"):
        y = tgg.grouped_linear(x, w, gs, precision="bf16",
                               config=KernelConfig(backend=PADDED))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(y, tgg.grouped_linear(x, w, gs,
                                                 precision="bf16"))
