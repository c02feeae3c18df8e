"""The port's flash attention against the JAX package's, on the same
numpy inputs.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode (``flash_attention(..., interpret=True)``) and ``attention_block``
with ``attn_backend="flash"``, which picks interpret mode on the CPU.  On
the CPU the port's wrapper takes its plain version, which repeats the
CUDA kernel's tiling (64-row tiles, causal tiles above the diagonal
skipped) in f32.  Inputs are f32 so the algorithm is compared, not a
rounding: the two sum scores and the online-softmax state in another
tile order (the reference's blocks are 64 to 256 rows), which moves an
output by a few f32 ulps of the largest, so outputs and gradients are
held within 1e-5 of the largest element.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention_kernel import \
    flash_attention as jflash_attention
from repro.kernels.flash_attention_kernel import \
    flash_attention_ref as jflash_attention_ref
from repro.kernels.flash_attention_kernel import \
    flash_attention_trainable as jflash_attention_trainable
from repro.models import attention as jattn
from repro_torch.configs import smoke_config
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels import flash_attention_kernel as fk
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

TOL = 1e-5

# the JAX package's CASES (tests/test_flash_attention.py)
CASES = [
    # b, hq, hkv, s, d, block_q, block_k
    (1, 2, 2, 256, 64, 128, 128),    # MHA
    (2, 4, 2, 256, 64, 128, 64),     # GQA g=2, uneven blocks
    (1, 8, 1, 128, 32, 64, 64),      # MQA
    (1, 2, 2, 512, 128, 256, 256),   # bigger tiles
]


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_oracle_match_jax_kernel(b, hq, hkv, s, d, bq, bk, causal):
    q, k, v = _inputs(b, hq, hkv, s, d)
    want = jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, block_q=bq, block_k=bk,
                            interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fk.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    assert _rel(got, want) <= TOL
    assert _rel(fk.flash_attention_plain(tq, tk, tv, causal=causal),
                want) <= TOL
    assert _rel(ref.flash_attention_ref(tq, tk, tv, causal=causal),
                want) <= TOL


def test_gqa_reads_kv_head_h_over_g():
    """q-head h reads kv-head h // (Hq/Hkv).  With distinct kv heads, the
    ``Tensor.repeat`` mapping (h -> h % Hkv) gives another result, so this
    case tells the two apart (an MHA model could not)."""
    b, hq, hkv, s, d = 1, 6, 3, 128, 32
    q, k, v = _inputs(b, hq, hkv, s, d, seed=5)
    k[:, 1] += 3.0          # make the kv heads plainly distinct
    v[:, 2] -= 2.0
    want = np.asarray(jflash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (fk.flash_attention_plain, ref.flash_attention_ref):
        assert _rel(fn(tq, tk, tv, causal=True), want) <= TOL
    # head h against kv head h // 2, one at a time
    for h in range(hq):
        one = ref.flash_attention_ref(tq[:, h:h + 1], tk[:, h // 2:h // 2 + 1],
                                      tv[:, h // 2:h // 2 + 1], causal=True)
        assert _rel(one, want[:, h:h + 1]) <= TOL
    g = hq // hkv
    wrong = ref.flash_attention_ref(tq, tk.repeat(1, g, 1, 1),
                                    tv.repeat(1, g, 1, 1), causal=True)
    assert _rel(wrong, want) > 0.1


@pytest.mark.parametrize("causal", [True, False])
def test_trainable_grads_match_jax(causal):
    b, hq, hkv, s, d = 2, 4, 2, 128, 32
    q, k, v = _inputs(b, hq, hkv, s, d, seed=7)
    dout = np.random.default_rng(8).standard_normal(
        (b, hq, s, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention_trainable(
        q_, k_, v_, causal, True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = fk.flash_attention_trainable(tq, tk, tv, causal)
    assert _rel(got, out) <= TOL
    got.backward(torch.from_numpy(dout))
    for t, w in zip((tq, tk, tv), want):
        assert t.grad.shape == t.shape
        assert _rel(t.grad, w) <= TOL


def test_checks_raise_value_errors():
    x = torch.zeros((1, 3, 64, 8))
    kv = torch.zeros((1, 2, 64, 8))
    for fn in (fk.flash_attention, fk.flash_attention_plain,
               fk.flash_attention_cuda):
        with pytest.raises(ValueError, match="multiple of Hkv"):
            fn(x, kv, kv)
    with pytest.raises(ValueError, match="blocks of 64"):
        fk.flash_attention(torch.zeros((1, 2, 96, 8)),
                           torch.zeros((1, 2, 96, 8)),
                           torch.zeros((1, 2, 96, 8)))
    with pytest.raises(ValueError, match="do not match"):
        fk.flash_attention(torch.zeros((1, 2, 64, 8)),
                           torch.zeros((1, 2, 128, 8)),
                           torch.zeros((1, 2, 128, 8)))
    # a CPU tensor never reaches the kernel's build or launch
    q = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        fk.flash_attention_cuda(q, q, q)
    assert fk.flash_attention_cuda.launches == 0


def _block_pair(seed, dtype):
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-1.7b"),
                               attn_backend="flash", dtype=dtype)
    p = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, dtype)
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"),
                              attn_backend="flash")
    return jcfg, p, cfg, tree_from_numpy(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("s", [128, 256, 64])
def test_attention_block_matches_jax(s, monkeypatch):
    """The port's attention sub-block (GQA 4/2 with qk-norm, the smoke
    qwen3-1.7b) against the JAX package's, f32, on the same params.  At
    S % 128 == 0 both take flash attention, at S = 64 both the chunked
    path; the prefill cache is the same K/V either way."""
    jcfg, jp, cfg, tp = _block_pair(s, jnp.float32)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, jcache = jax.jit(lambda p, x: jattn.attention_block(
        p, x, jcfg, jnp.asarray(pos), mode="prefill",
        cache_capacity=s + 4))(jp, jnp.asarray(x))
    calls = []
    real = tattn.flash_attention_trainable
    monkeypatch.setattr(tattn, "flash_attention_trainable",
                        lambda *a: calls.append(1) or real(*a))
    got, tcache = tattn.attention_block(
        tp, torch.from_numpy(x), cfg, torch.from_numpy(pos), mode="prefill",
        cache_capacity=s + 4)
    assert len(calls) == (1 if s % 128 == 0 else 0)
    assert _rel(got, want) <= TOL
    # the cache holds K/V rounded to bf16 in both packages: within one
    # bf16 step (an f32 ulp apart upstream can round either way)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key].float().numpy(),
            np.asarray(jcache[key].astype(jnp.float32)), rtol=2.0 ** -7,
            atol=1e-6)


def test_attention_block_trains_through_flash():
    """Gradients through the flash branch equal those through the chunked
    path of the same block (the backward is the oracle's)."""
    _, _, cfg, tp = _block_pair(1, jnp.float32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32))
    pos = torch.arange(128, dtype=torch.int32)
    grads = []
    for backend in ("flash", "chunked"):
        c = dataclasses.replace(cfg, attn_backend=backend)
        leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()
                  if isinstance(t, torch.Tensor)}
        out, _ = tattn.attention_block({**tp, **leaves}, x, c, pos)
        out.square().sum().backward()
        grads.append({k: t.grad for k, t in leaves.items()})
    for k in grads[0]:
        assert _rel(grads[0][k], grads[1][k].numpy()) <= TOL
