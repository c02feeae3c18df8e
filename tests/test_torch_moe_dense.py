"""The port's dense (GShard capacity-bucket) MoE dispatch against the JAX
package's ``moe_apply(dispatch="dense")``, on the same params.

Both run the routed experts as three batched products in x's dtype and
drop the rows past an expert's capacity.  Tolerances, each the existing
one for its dtype: f32 within 1e-5 of the largest element (forward and
every gradient; both sum the same f32 products, in another order); bf16
within 1e-2 of the largest output, as the bf16 MoE layer in
``tests/test_torch_moe.py`` (each product and silu(g) * u round to bf16 in
both), and its gradients within 5e-2 of their largest element, as the MoE
layer's in ``tests/test_torch_train.py``.  The one place the two differ
on purpose (ROADMAP C): when the last expert overflows, the reference
overwrites that expert's last kept row with the zeros of its dropped rows;
the port keeps it.  A whole smoke model with ``moe_dispatch="dense"`` is
held as the bf16 whole models are: logits within 2e-2 of the largest, a
3-step loss trajectory within 2e-2 and its first loss within 5e-3.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import moe as jmoe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.analysis import events
from repro_torch.configs import smoke_config
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 tensor_from_numpy, tree_from_numpy)
from repro_torch.core import moe as tmoe
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model_zoo import make_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step

DIMS = dict(num_experts=8, top_k=2, d_model=256, d_ff_expert=128,
            num_shared_experts=2)
TOKENS, SEED = 48, 4
TOL = {"f32": (1e-5, 1e-5), "bf16": (1e-2, 5e-2)}


def rel_to_max(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_dispatch_matches_jax(dtype, capacity_factor):
    """Forward and the gradients of sum(y * c) + 0.1 * aux for every param
    and for x.  At capacity_factor 0.5 each expert keeps 8 of its rows
    (48 tokens x top-2 over 8 experts): most experts drop rows, the last
    exactly fills its bucket."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcfg = jmoe.MoEConfig(**DIMS, capacity_factor=capacity_factor,
                          precision="bf16", dispatch="dense")
    params = jmoe.init_moe_params(jax.random.PRNGKey(SEED), jcfg, dtype=jd)
    rng = np.random.default_rng(SEED)
    x = jnp.asarray(rng.standard_normal((TOKENS, DIMS["d_model"])), jd)
    c = jnp.asarray(rng.standard_normal((TOKENS, DIMS["d_model"])),
                    jnp.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y.astype(jnp.float32) * c) \
            + 0.1 * aux["load_balance_loss"], y
    (_, want), (want_p, want_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, x)

    tcfg = tmoe.MoEConfig(**DIMS, capacity_factor=capacity_factor,
                          precision="bf16", dispatch="dense")
    tp = tree_from_numpy(jax.tree.map(np.asarray, params))
    for v in tp.values():
        v.requires_grad_()
    tx = tensor_from_numpy(np.asarray(x)).requires_grad_()
    with events.capture() as evs:
        y, aux = tmoe.moe_apply(tp, tx, tcfg)
    counts = torch.bincount(aux["expert_ids"].reshape(-1), minlength=8)
    if capacity_factor < 1:
        assert int(counts.max()) > 8 and int(counts[-1]) == 8
    # no plan and no quantization: the buckets are plain products
    assert events.count(evs, "plan_build") == 0
    assert events.count(evs, "quantize_tilewise") == 0
    loss = (y.float() * tensor_from_numpy(np.asarray(c))).sum() \
        + 0.1 * aux["load_balance_loss"]
    loss.backward()

    fwd_tol, grad_tol = TOL[dtype]
    assert y.dtype == tx.dtype and y.shape == want.shape
    assert rel_to_max(y, want) <= fwd_tol
    assert rel_to_max(tx.grad, want_x) <= grad_tol
    for name, v in tp.items():
        assert v.grad is not None and v.grad.dtype == v.dtype, name
        err = rel_to_max(v.grad, want_p[name])
        assert err <= grad_tol, (name, err)


def test_fp8_shared_experts_keep_their_kernels():
    """Under ``precision="fp8"`` the routed buckets stay in x's dtype and
    the shared experts run the fp8 path: one plan and one quantization,
    of x alone; the output is within the fp8 MoE layer's 2e-2 of JAX's."""
    jcfg = jmoe.MoEConfig(**DIMS, precision="fp8", dispatch="dense",
                          backend="xla_exact")
    params = jmoe.init_moe_params(jax.random.PRNGKey(SEED), jcfg,
                                  dtype=jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(SEED).standard_normal(
        (TOKENS, DIMS["d_model"])), jnp.bfloat16)
    want, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(params, x)
    tcfg = tmoe.MoEConfig(**DIMS, precision="fp8", dispatch="dense")
    tp = tree_from_numpy(jax.tree.map(np.asarray, params))
    with events.capture() as evs, torch.inference_mode():
        got, _ = tmoe.moe_apply(tp, tensor_from_numpy(np.asarray(x)), tcfg)
    assert events.count(evs, "plan_build") == 1
    assert [e.data["shape"] for e in events.of_kind(evs, "quantize_tilewise")
            ] == [(TOKENS, DIMS["d_model"])]
    assert rel_to_max(got, want) <= 2e-2


def test_overflowing_last_expert_keeps_its_last_row():
    """The reference's defect, pinned.  32 one-hot tokens, top-1, routed
    6 / 6 / 6 / 14 over 4 experts at capacity_factor 1.0: buckets of 8
    rows, so expert 3 keeps tokens 18..25 and drops 26..31.  The
    reference scatters the dropped rows as zeros onto expert 3's last
    slot after its kept row, so token 25 loses its expert and comes back
    0; the port keeps it.  Every other row agrees within f32's 1e-5."""
    d = dict(num_experts=4, top_k=1, d_model=128, d_ff_expert=128,
             num_shared_experts=0, capacity_factor=1.0, dispatch="dense")
    jcfg = jmoe.MoEConfig(**d)
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg)
    assign = np.array([0] * 6 + [1] * 6 + [2] * 6 + [3] * 14)
    router = np.zeros((128, 4), np.float32)
    router[np.arange(32), assign] = 10.0
    params = dict(params, router=jnp.asarray(router))
    x = np.eye(32, 128, dtype=np.float32)
    want, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(
        params, jnp.asarray(x))
    want = np.asarray(want)
    tp = tree_from_numpy(jax.tree.map(np.asarray, params))
    got, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tmoe.MoEConfig(**d))
    got = got.numpy()

    zero = lambda y: np.flatnonzero(np.abs(y).max(1) == 0)  # noqa: E731
    assert list(zero(want)) == list(range(25, 32))
    assert list(zero(got)) == list(range(26, 32))
    others = np.arange(32) != 25
    assert np.abs(got[others] - want[others]).max() \
        <= 1e-5 * np.abs(want).max()
    # token 25 through expert 3, weighted by its routing probability
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    logits = x[25] @ p["router"]
    prob = np.exp(logits[3] - logits.max()) / np.exp(
        logits - logits.max()).sum()
    g, u = x[25] @ p["w_gate"][3], x[25] @ p["w_up"][3]
    row = prob * ((g / (1 + np.exp(-g)) * u) @ p["w_down"][3])
    assert np.abs(got[25] - row).max() <= 1e-5 * np.abs(row).max()


def test_whole_model_with_dense_dispatch_matches_jax():
    """The smoke qwen2-moe-a2.7b in bf16 with ``moe_dispatch="dense"`` in
    both packages, from the same params: prefill logits, then 3 train
    steps."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-moe-a2.7b"),
                               precision="bf16", moe_dispatch="dense")
    jmodel = jzoo.make_model(jcfg)
    init = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"),
                              precision="bf16", moe_dispatch="dense")
    model = make_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, init), cfg)

    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    jl, _ = jax.jit(jmodel.prefill)(init, {"tokens": jnp.asarray(
        tokens, jnp.int32)})
    with torch.inference_mode():
        tl, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert rel_to_max(tl, jl) <= 2e-2

    opt_kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jopt = jadamw.OptConfig(**opt_kw)
    jstate = jadamw.init_opt_state(init, jopt)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    jstep = jax.jit(jmake_train_step(jmodel.loss, jopt))
    step = make_train_step(model.loss, adamw.OptConfig(**opt_kw))
    jdata = JSyntheticLM(JDataConfig(batch_size=4, seq_len=32), jcfg)
    data = SyntheticLM(DataConfig(batch_size=4, seq_len=32), cfg)
    jparams, want, got = init, [], []
    for s in range(3):
        jparams, jstate, m = jstep(jparams, jstate, jdata.batch_at(s))
        want.append(float(m["loss"]))
        params, state, m = step(params, state, data.batch_at(s))
        got.append(float(m["loss"]))
    assert abs(got[0] - want[0]) <= 5e-3, (got, want)
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert got[-1] < got[0]
