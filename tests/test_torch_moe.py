"""The port's MoE layer against the JAX package's ``moe_apply`` (fp8,
ragged dispatch, Pallas kernels in interpret mode), on the same params.

Routing is discrete, so the expert ids must be equal.  The outputs differ
by the fused epilogue's e4m3 steps (silu's exp rounds an ulp apart
between XLA and PyTorch) and the bf16 rounding of the GEMMs: within 2% of
the largest output, which these seeds meet with a wide margin.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import moe as jmoe
from repro.kernels.plan import KernelConfig as JConfig
from repro_torch.analysis import events
from repro_torch.convert import tree_from_numpy
from repro_torch.core import moe as tmoe
from repro_torch.kernels.plan import KernelConfig

DIMS = dict(num_experts=8, top_k=2, d_model=256, d_ff_expert=128,
            num_shared_experts=2)


def _run(block_m, tokens, seed, precision="fp8", fuse_producer=False):
    jcfg = jmoe.MoEConfig(**DIMS, precision=precision,
                          backend="pallas_interpret",
                          kernel_config=JConfig(block_m=block_m,
                                                fuse_producer=fuse_producer))
    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg,
                                  dtype=jnp.bfloat16)
    x = np.random.default_rng(seed).standard_normal(
        (tokens, DIMS["d_model"])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(params, jx)
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ params["router"], -1)
    _, jids = jax.lax.top_k(probs, DIMS["top_k"])

    tcfg = tmoe.MoEConfig(**DIMS, precision=precision,
                          kernel_config=KernelConfig(
                              block_m=block_m, fuse_producer=fuse_producer))
    tparams = tree_from_numpy(jax.tree.map(np.asarray, params))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    with events.capture() as evs, torch.inference_mode():
        got, taux = tmoe.moe_apply(tparams, tx, tcfg)
    return want, jaux, np.asarray(jids), got, taux, evs


@pytest.mark.parametrize("block_m,tokens", [(128, 32), (16, 8), (16, 40)])
def test_moe_apply_matches_jax(block_m, tokens):
    want, jaux, jids, got, taux, evs = _run(block_m, tokens, seed=tokens)
    np.testing.assert_array_equal(taux["expert_ids"].numpy(), jids)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-5)
    # XLA divides by the slot count as a multiply by its reciprocal
    assert abs(float(taux["dropped_fraction"])
               - float(jaux["dropped_fraction"])) <= 1e-6
    # plan-once and quantize-once: one plan and one quantization for the
    # routed experts, one each for the shared experts
    assert events.count(evs, "plan_build") == 2
    assert [e.data["shape"] for e in events.of_kind(evs, "quantize_tilewise")] \
        == [(tokens * DIMS["top_k"], 256), (tokens, 256)]


@pytest.mark.parametrize("block_m,tokens", [(128, 32), (16, 8)])
@pytest.mark.parametrize("variant", ["fp8_fused", "bf16"])
def test_moe_apply_variants_match_jax(variant, block_m, tokens):
    """The producer-fused fp8 recipe and the bf16 recipe against the JAX
    package's.  Fused: the gate/up GEMMs emit fp8, so the FFN runs one
    standalone quantization per expert FFN, xs and the shared x.  bf16:
    no quantization at all; silu(g) * u in bf16 with one rounding per
    operation, as the reference; the bf16 GEMMs agree to one bf16 step,
    so the bound is the fp8 path's or tighter."""
    fused = variant == "fp8_fused"
    want, jaux, jids, got, taux, evs = _run(
        block_m, tokens, seed=tokens + 1,
        precision="fp8" if fused else "bf16", fuse_producer=fused)
    np.testing.assert_array_equal(taux["expert_ids"].numpy(), jids)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= (2e-2 if fused else 1e-2), err
    shapes = [e.data["shape"] for e in events.of_kind(evs,
                                                      "quantize_tilewise")]
    assert shapes == ([(tokens * DIMS["top_k"], 256), (tokens, 256)]
                      if fused else [])
    # the routed experts' plan; the bf16 shared experts are plain matmuls
    assert events.count(evs, "plan_build") == (2 if fused else 1)


def test_unported_modes_raise():
    """The dispatch is ragged or dense (``tests/test_torch_moe_dense.py``),
    nothing else; expert parallelism (``tests/test_torch_moe_ep.py``)
    needs the experts to divide over the ranks."""
    cfg = tmoe.MoEConfig(**DIMS)
    x = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_apply({}, x, dataclasses.replace(cfg, dispatch="gshard"))
    with pytest.raises(ValueError, match="expert rank"):
        tmoe.moe_apply({}, x, cfg, ep_size=3)
    assert tmoe._capacity(96, 1, 2.0) == 96
    assert tmoe._capacity(96, 4, 2.0, align=16) == 48


def test_init_moe_params_shapes():
    cfg = tmoe.MoEConfig(**DIMS)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(cfg, generator=gen, device="cpu",
                             dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].shape == (8, 256, 128) and p["w_gate"].dtype == torch.bfloat16
    assert p["w_down"].shape == (8, 128, 256)
    assert p["shared_gate"].shape == (256, 256)
    assert p["shared_down"].shape == (256, 256)
