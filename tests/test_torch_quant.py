"""The port's quantizers against the JAX package's Pallas kernels (run in
interpret mode on the CPU).

The 1x128 quantizer and the blockwise weight quantizer must agree bit for
bit.  The fused activation->quantize epilogue may differ by one e4m3 step
per element: silu's exp and gelu's tanh can round an ulp apart between
XLA and PyTorch, which can move a value across an e4m3 rounding boundary.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import quantization as jquant
from repro.kernels.epilogue_kernel import act_quantize_pallas
from repro.kernels.quant_kernel import quantize_tilewise_pallas
from repro_torch.analysis import events
from repro_torch.core import quantization as tquant
from repro_torch.kernels import epilogue_kernel, quant_kernel, ref


def _np_input(shape, seed, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    x[0, :128] = 0.0                  # an all-zero tile gets scale 1
    return x


def _bytes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def e4m3_step(q):
    """Spacing of e4m3 values at |q| (2^-9 in the subnormal range)."""
    a = np.abs(np.asarray(q, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -6))) - 3)


@pytest.mark.parametrize("shape", [(64, 512), (5, 128), (40, 1408)])
def test_quantize_tilewise_bitwise(shape):
    x = _np_input(shape, 0)
    q, s = quantize_tilewise_pallas(jnp.asarray(x), interpret=True)
    tq, ts = quant_kernel.quantize_tilewise(torch.from_numpy(x))
    assert tq.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(q), _bytes(tq))
    np.testing.assert_array_equal(np.asarray(s), ts.numpy())
    # the oracle agrees with the kernel's plain version too
    rq, rs = ref.quantize_tilewise_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(_bytes(rq), _bytes(tq))
    np.testing.assert_array_equal(rs.numpy(), ts.numpy())


def test_dequantize_round_trip_within_e4m3_precision():
    x = torch.from_numpy(_np_input((8, 384), 5))
    q, s = ref.quantize_tilewise_ref(x)
    back = ref.dequantize_tilewise_ref(q, s)
    assert torch.all((back - x).abs() <= x.abs() * 2.0 ** -4 + s.max() * 2.0 ** -9)
    w = torch.from_numpy(_np_input((2, 256, 384), 6))
    qb, sb = ref.quantize_blockwise_ref(w)
    wb = ref.dequantize_blockwise_ref(qb, sb)
    assert wb.shape == w.shape
    assert torch.all((wb - w).abs() <= w.abs() * 2.0 ** -4 + sb.max() * 2.0 ** -9)


def test_quantize_activation_record_and_event():
    x = _np_input((16, 256), 1)
    with events.capture() as evs:
        qa = tquant.quantize_activation(torch.from_numpy(x).bfloat16())
    assert events.of_kind(evs, "quantize_tilewise")[0].data["shape"] == (16, 256)
    jq = jquant.quantize_activation(jnp.asarray(x, jnp.bfloat16),
                                    backend="pallas_interpret")
    np.testing.assert_array_equal(_bytes(jq.q), _bytes(qa.q))
    np.testing.assert_array_equal(np.asarray(jq.scale), qa.scale.numpy())


@pytest.mark.parametrize("shape", [(3, 256, 384), (1, 128, 128)])
def test_quantize_blockwise_bitwise(shape):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jb, jsb = jax.jit(jquant.quantize_blockwise_batched)(jnp.asarray(w))
    tb, tsb = tquant.quantize_blockwise_batched(torch.from_numpy(w))
    np.testing.assert_array_equal(_bytes(jb), _bytes(tb))
    np.testing.assert_array_equal(np.asarray(jsb), tsb.numpy())
    b2, s2 = tquant.quantize_blockwise(torch.from_numpy(w[0]))
    np.testing.assert_array_equal(_bytes(b2), _bytes(tb[0]))
    np.testing.assert_array_equal(s2.numpy(), tsb[0].numpy())


@pytest.mark.parametrize("act", ["silu_mul", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quantize_within_one_e4m3_step(act, dtype):
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((48, 384)) * 2).astype(np.float32)
    u = (rng.standard_normal((48, 384)) * 2).astype(np.float32)
    jg, ju = jnp.asarray(g, dtype), jnp.asarray(u, dtype)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(getattr(torch, dtype))
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32))).to(getattr(torch, dtype))
    unary = act == "gelu"
    jqv, js = act_quantize_pallas(jg, None if unary else ju, act=act,
                                  interpret=True)
    tq, ts = epilogue_kernel.act_quantize(tg, None if unary else tu, act=act)
    jq_f = np.asarray(jqv.astype(jnp.float32))
    tq_f = tq.float().numpy()
    js, ts = np.asarray(js), ts.numpy()
    # scales come from amax of the activation: an ulp of the activation
    np.testing.assert_allclose(ts, js, rtol=2e-6, atol=0)
    deq_j = jq_f * np.repeat(js, 128, axis=1)
    deq_t = tq_f * np.repeat(ts, 128, axis=1)
    step = np.maximum(e4m3_step(jq_f) * np.repeat(js, 128, axis=1),
                      e4m3_step(tq_f) * np.repeat(ts, 128, axis=1))
    assert np.all(np.abs(deq_j - deq_t) <= step * (1 + 1e-5))
    # the fused record equals the unfused oracle of the port
    rq, rs = ref.act_quantize_ref(tg, None if unary else tu, act)
    np.testing.assert_array_equal(_bytes(rq), _bytes(tq))
    qa = tquant.fused_act_quantize(tg, None if unary else tu, act=act)
    np.testing.assert_array_equal(_bytes(qa.q), _bytes(tq))


def test_act_quantize_argument_checks():
    g = torch.zeros((8, 128))
    s = torch.ones((8, 1))
    # the fp8-input mode's checks, the reference's ValueErrors
    with pytest.raises(ValueError, match="scales for both operands"):
        epilogue_kernel.act_quantize(g, g, s_g=s)
    with pytest.raises(ValueError, match="s_u without s_g"):
        epilogue_kernel.act_quantize(g, g, s_u=s)
    with pytest.raises(ValueError, match="need 1x128 scales"):
        epilogue_kernel.act_quantize(g, g, s_g=torch.ones((8, 2)), s_u=s)
    with pytest.raises(ValueError, match="needs both"):
        epilogue_kernel.act_quantize(g, None, act="silu_mul")
    with pytest.raises(ValueError, match="unary"):
        epilogue_kernel.act_quantize(g, g, act="gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        epilogue_kernel.act_quantize(g, g, act="relu")
    with pytest.raises(ValueError, match="multiple of 128"):
        quant_kernel.quantize_tilewise(torch.zeros((4, 100)))


def test_cpu_tensors_never_reach_the_kernels():
    """A CPU tensor takes the plain version; the CUDA wrappers refuse it
    (on a card they launch, never fall back)."""
    before = (quant_kernel.quantize_tilewise_cuda.launches,
              epilogue_kernel.act_quantize_cuda.launches)
    x = torch.randn(4, 256)
    quant_kernel.quantize_tilewise(x)
    epilogue_kernel.act_quantize(x, x)
    assert (quant_kernel.quantize_tilewise_cuda.launches,
            epilogue_kernel.act_quantize_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        quant_kernel.quantize_tilewise_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue_kernel.act_quantize_cuda(x, x)
