"""The wgrads at every geometry of the JAX package's tuning pool: span 2
and 4 (``n_span = k_span``) and ``block_n`` 256.

On the CPU the port's wgrads run their plain versions, which compute
span 1's dw at any geometry; the JAX package's Pallas kernels
``gmm_pallas_wgrad`` / ``gmm_pallas_wgrad_fp8`` run the super-tile walk
in interpret mode.  They are held together at ``test_torch_wgrad.py``'s
tolerance: 1e-5 of the largest |dw| (both sum exact products in f32, in
another order); empty groups exactly zero and a NaN tail excluded.  The
CUDA wrappers take the pool's geometries and refuse any other with the
resource model's reason before they look at the shapes or the device.
A model trained one step at span 2 is bitwise its span-1 step, and holds
to the JAX package's step at the zoo tests' tolerances.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.kernels.plan import KernelConfig as JConfig
from repro.kernels.wgrad_kernel import gmm_pallas_wgrad, gmm_pallas_wgrad_fp8
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro_torch.configs import smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax, \
    tensor_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import resources as res
from repro_torch.kernels import wgrad_kernel as twk
from repro_torch.kernels.plan import KernelConfig
from repro_torch.kernels.ref import quantize_tilewise_ref
from repro_torch.models.model_zoo import make_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_leaves

TOL = 1e-5
# the zoo tests' loss and gradient bounds (tests/test_torch_zoo_models.py)
LOSS_TOL, GRAD_TOL = 5e-3, 0.08
# (block_n, n_span, k_span) of the pool's wgrad entries past span 1, and
# their names: "bn256" span 1 at block_n 256, "span2" and "span4"
GEOMETRIES = [g for g in res.WGRAD_GEOMETRIES if g != (128, 1, 1)]
GEOMETRY_IDS = [f"bn{g[0]}" if g[1] == 1 else f"span{g[1]}"
                for g in GEOMETRIES]
# ragged groups with an empty one, rows past their sum (the NaN tail)
SIZES, M, KN = [70, 0, 133, 1, 90], 330, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the shapes are small, and
    beside the other test workers a thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


def _operands(fp8, seed):
    """x [M, 512], dy [M, 512] with NaN in every row past sum(SIZES): bf16
    for B4, or their 1x128 e4m3 quantizations (payload and scales) for
    B6; the JAX arrays and the port's tensors of the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, KN)).astype(np.float32)
    dy = (rng.standard_normal((M, KN)) * 1e-2).astype(np.float32)
    if fp8:
        quant = jax.jit(jref.quantize_tilewise_ref)
        j = [*quant(jnp.asarray(x)), *quant(jnp.asarray(dy))]
    else:
        j = [jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)]
    total = sum(SIZES)
    j = [a.at[total:].set(jnp.nan) for a in j]
    return j, [tensor_from_numpy(np.asarray(a)) for a in j]


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=GEOMETRY_IDS)
def test_plain_wgrad_matches_pallas_at_each_geometry(geometry, fp8):
    block_n, n_span, k_span = geometry
    geo = dict(block_n=block_n, n_span=n_span, k_span=k_span)
    j, t = _operands(fp8, seed=block_n + 7 * n_span + fp8)
    jgs = jnp.asarray(SIZES, jnp.int32)
    tgs = torch.tensor(SIZES, dtype=torch.int32)
    jfn, tfn = ((gmm_pallas_wgrad_fp8, twk.gmm_wgrad_fp8) if fp8
                else (gmm_pallas_wgrad, twk.gmm_wgrad))
    pallas = jfn(*j, jgs, block_m=128, interpret=True, **geo)
    got = tfn(*t, tgs, **geo)
    assert got.shape == (len(SIZES), KN, KN) and torch.isfinite(got).all()
    _close(got.numpy(), pallas)
    # the plain version computes span 1's dw at every geometry
    assert torch.equal(got, tfn(*t, tgs))
    for g, s in enumerate(SIZES):
        if s == 0:
            assert (got[g] == 0).all()
            assert (np.asarray(pallas)[g] == 0).all()


@pytest.mark.parametrize("bad,why", [
    ({"n_span": 3, "k_span": 3}, "n_span=3, k_span=3"),
    ({"block_n": 384}, "block_n=384"),
    ({"block_n": 256, "n_span": 2, "k_span": 2}, "block_n=256, n_span=2"),
])
def test_cuda_wrappers_refuse_geometries_outside_the_pool(bad, why):
    """The reason names the pool's geometries and the one asked for, and
    comes before the shapes (K = N = 512 divide none of these) or the
    device (the tensors lie on the CPU) are looked at; nothing
    launches."""
    _, t = _operands(False, seed=1)
    (x8, sx), (d8, sd) = (quantize_tilewise_ref(v.float().nan_to_num())
                          for v in t)
    gs = torch.tensor(SIZES, dtype=torch.int32)
    before = (twk.gmm_wgrad_cuda.launches, twk.gmm_wgrad_fp8_cuda.launches)
    for call in (lambda: twk.gmm_wgrad_cuda(*t, gs, **bad),
                 lambda: twk.gmm_wgrad_fp8_cuda(x8, sx, d8, sd, gs, **bad)):
        with pytest.raises(ValueError) as exc:
            call()
        msg = str(exc.value)
        assert msg.startswith("no CUDA variant") and why in msg, msg
        assert str(res.WGRAD_GEOMETRIES) in msg
    assert (twk.gmm_wgrad_cuda.launches,
            twk.gmm_wgrad_fp8_cuda.launches) == before


def _step(model, params, state, batch):
    """One step of the port's trainer: its gradients (before AdamW), the
    loss and the updated params (copies: AdamW updates in place)."""
    opt = adamw.OptConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    step = make_train_step(model.loss, opt)
    (loss, _), grads = step.grad_fn(params, batch)
    kept = [g.clone() for g in tree_leaves(grads)]
    params, state, _ = step.update(params, grads, state)
    return float(loss), kept, [p.clone() for p in tree_leaves(params)]


def test_yi_fp8_span2_step_is_span1_bitwise_and_near_jax():
    """The smoke yi-9b (d 256, d_ff 512: span 2's 256 x 256 super-tile
    divides every MLP weight) in fp8, one train step from the JAX
    package's init: under ``KernelConfig(n_span=2, k_span=2)`` the
    port's loss, gradients and updated params equal its span-1 step's
    bit for bit; the loss within 5e-3 of the JAX package's step at the
    same config (its wgrads through the Pallas kernels in interpret
    mode, at span 2) and every gradient within 8% of its norm."""
    name = "yi-9b"
    span = dict(n_span=2, k_span=2)
    jcfg = dataclasses.replace(
        jax_smoke_config(name), precision="fp8",
        kernel_config=JConfig(backend="pallas_interpret", **span))
    jmodel = jzoo.make_model(jcfg)
    init = jmodel.init_params(jax.random.PRNGKey(0))
    jbatch = JSyntheticLM(JDataConfig(batch_size=2, seq_len=64),
                          jcfg).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss,
                                                    has_aux=True))(init,
                                                                   jbatch)
    init_state = jax.tree.map(np.asarray, jadamw.init_opt_state(
        init, jadamw.OptConfig(lr=3e-3, warmup_steps=1, total_steps=3)))
    init = jax.tree.map(np.asarray, init)

    runs = {}
    for label, kc in (("span1", KernelConfig()),
                      ("span2", KernelConfig(**span))):
        cfg = dataclasses.replace(smoke_config(name), precision="fp8",
                                  kernel_config=kc)
        assert cfg.d_model % 256 == 0 and cfg.d_ff % 256 == 0
        model = make_model(cfg, "cpu")
        batch = SyntheticLM(DataConfig(batch_size=2, seq_len=64),
                            cfg).batch_at(0)
        runs[label] = _step(model, params_from_jax(init, cfg),
                            opt_state_from_jax(init_state, cfg), batch)
    (loss1, grads1, params1), (loss2, grads2, params2) = \
        runs["span1"], runs["span2"]
    assert loss2 == loss1
    assert all(torch.equal(a, b) for a, b in zip(grads1, grads2))
    assert all(torch.equal(a, b) for a, b in zip(params1, params2))

    assert abs(loss2 - float(jloss)) <= LOSS_TOL, (loss2, float(jloss))
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                       cfg))
    for g, w in zip(grads2, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_TOL, (tuple(g.shape), err)
