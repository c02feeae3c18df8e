"""The port's deepseek-moe-16b (64 routed experts top-6, 2 shared, a dense
first layer) against the JAX package's, at the smoke config on the same
params, with the default backend and with ``gemm_backend=
"padded_baseline"`` in both packages.

The JAX side runs its fp8 GEMMs on the Pallas kernels in interpret mode
(``"pallas_interpret"``), or under ``"padded_baseline"``, whose inner
GEMM is that kernel on the CPU; the port runs its plain versions.  The
JAX package's config is bf16, so it is run with ``precision="fp8"``, the
port's.  Tolerances, each with its reason.  A bf16 ulp apart upstream
of an e4m3 quantization becomes whole e4m3 steps (up to 2^-3 of a
value), in the JAX package as much as in the port (the attention blocks
of the two packages differ by one bf16 ulp on ~0.2% of their outputs).
How far that moves this model was measured on the JAX package alone:
with 0.2% of its embedding entries one bf16 ulp apart, its own prefill
and decode logits here move by up to 10.5% of the largest logit (those
of the smoke qwen2-moe-a2.7b by up to 15.4%), and each weight's gradient
of one batch by up to 14% of its norm (qwen2: 12%).  So the logits are
held within 15% of the largest logit (``tests/test_torch_serve.py``'s
10% for qwen2-moe-a2.7b is met there at its seed, and missed here at one
decode step, by 10.4%); each greedy token must be the JAX package's
argmax on the same tokens, or within that bound of it (at this seed a
near-tie flips row 0's second token), and the first ones equal; the
loss of one
batch within 5e-3 (the first loss of the trajectories of
``tests/test_torch_train.py``) and each weight's gradient within 20% of
its norm; each module is held tight in its own test file, and the
padded model bitwise against the padding-free one.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels.plan import KernelConfig as JConfig
from repro.models import model_zoo as jzoo
from repro_torch.analysis import events
from repro_torch.configs import PORTED, get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.plan import PLAN_CACHE, KernelConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model_zoo import make_model
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's ops while this file runs: the
    smoke shapes gain nothing from more, and beside the other test
    workers PyTorch's thread pool oversubscribes the cores.  Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NAME = "deepseek-moe-16b"
BATCH, PROMPT, NEW = 2, 16, 6
TOL = 0.15
GRAD_TOL = 0.2
BACKENDS = (None, "padded_baseline")


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def check_logits(got, want, tol=TOL):
    got = got.float().numpy()
    want = _np(want)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, err


def _jax_cfg(backend):
    return dataclasses.replace(jax_smoke_config(NAME), precision="fp8",
                               gemm_backend=backend or "pallas_interpret")


@pytest.fixture(scope="module")
def jax_params():
    jparams = jzoo.make_model(_jax_cfg(None)).init_params(
        jax.random.PRNGKey(0))
    return jparams, jax.tree.map(np.asarray, jparams)


def test_deepseek_config():
    """The reference's config, in fp8; the param count is the tree's:
    the port's smoke tree and (by shapes alone) the JAX package's full
    tree."""
    assert NAME in PORTED
    cfg, jcfg = get_config(NAME), jax_get_config(NAME)
    for f in ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "d_ff", "vocab_size", "head_dim", "rope_theta", "norm_eps",
              "tie_embeddings", "attn_chunk", "qkv_bias", "qk_norm"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(smoke_config(NAME), f) == \
            getattr(jax_smoke_config(NAME), f), f
    for c, jc in ((cfg, jcfg), (smoke_config(NAME), jax_smoke_config(NAME))):
        assert dataclasses.asdict(c.moe) == dataclasses.asdict(jc.moe)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.num_shared_experts,
            cfg.moe.first_dense_layers, cfg.d_ff) == (64, 6, 2, 1, 10944)
    assert cfg.precision == "fp8" and cfg.gemm_backend is None
    assert cfg.param_count() == 16_375_728_128
    small = smoke_config(NAME)
    params = make_model(small, "cpu").init_params(torch.Generator()
                                                  .manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(params)) == small.param_count()
    shapes = jax.eval_shape(jzoo.make_model(jcfg).init_params,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == \
        cfg.param_count()


def test_params_from_jax_carries_pre0(jax_params):
    """The JAX package's ``pre0`` (the dense first layer) becomes layer 0
    and its stacked MoE layers the rest, with the port's own structure,
    shapes and values."""
    jparams, np_tree = jax_params
    cfg = smoke_config(NAME)
    params = params_from_jax(np_tree, cfg)
    own = make_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.num_layers == 3
    assert "mlp" in params["layers"][0] and "moe" not in params["layers"][0]
    assert all("moe" in lp and "mlp" not in lp
               for lp in params["layers"][1:])
    for a, b in zip(tree_leaves(params), tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(
        params["layers"][0]["mlp"]["w_gate"].float().numpy(),
        np_tree["pre0"]["mlp"]["w_gate"].astype(np.float32))
    np.testing.assert_array_equal(
        params["layers"][2]["moe"]["w_down"].float().numpy(),
        np_tree["layers"]["b0"]["moe"]["w_down"][1].astype(np.float32))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(np_tree, dataclasses.replace(cfg, num_layers=4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_decode_and_generate_match_jax(jax_params, backend):
    """Prefill and teacher-forced decode logits, then greedy generation,
    against the JAX package's on the same params, prefill on 128-row and
    decode on 16-row tiles in both; under the baseline both pad each
    group to that tile."""
    jparams, np_tree = jax_params
    jcfg = _jax_cfg(backend)
    jmodel = jzoo.make_model(jcfg)
    cfg = dataclasses.replace(smoke_config(NAME), gemm_backend=backend)
    model = make_model(cfg, "cpu")
    params = params_from_jax(np_tree, cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (BATCH, PROMPT))
    cap = PROMPT + NEW
    jdec_cfg = JConfig(block_m=16, backend=jcfg.gemm_backend)
    jdec = jzoo.with_kernel_config(jmodel, jdec_cfg)
    jprefill = jax.jit(functools.partial(jmodel.prefill, cache_capacity=cap))
    jstep = jax.jit(jdec.decode_step)
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})

    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    assert engine.decode_config == KernelConfig(block_m=16, backend=backend)
    with torch.inference_mode():
        tl, tcache = engine.prefill({"tokens": torch.from_numpy(tokens)}, cap)
        check_logits(tl, jl[:, -1])
        forced = np.random.default_rng(2).integers(0, 512, (NEW - 1, BATCH))
        for tok in forced:
            jl, jcache = jstep(jparams, jnp.asarray(tok[:, None], jnp.int32),
                               jcache)
            tl, tcache = engine.decode_step(torch.from_numpy(tok), tcache)
            check_logits(tl, jl[:, 0])

    # the JAX package's logits on the port's own greedy tokens
    got = engine.generate({"tokens": torch.from_numpy(tokens)}).tokens.numpy()
    assert got.shape == (BATCH, NEW)
    jl, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    jl = jl[:, -1]
    for i in range(NEW):
        lg = _np(jl)
        chosen = lg[np.arange(BATCH), got[:, i]]
        assert np.all(chosen >= lg.max(-1) - TOL * np.abs(lg).max()), i
        if i == 0:
            np.testing.assert_array_equal(got[:, 0], lg.argmax(-1))
        jl, jcache = jstep(jparams, jnp.asarray(got[:, i:i + 1], jnp.int32),
                           jcache)
        jl = jl[:, 0]


def test_padded_model_equals_the_padding_free_one():
    """Inside the port the baseline moves no bit of the logits or the
    tokens; the padding-free forward builds one plan a layer (the dense
    layer: one a GEMM), and each padded GEMM plans over its padded sizes
    through the plan cache, so a padded forward builds one plan a static
    padded shape: the routed GEMMs', and the G = 1 GEMMs' (the dense
    layer's and the shared experts', over the same tokens)."""
    cfg = smoke_config(NAME)
    params = make_model(cfg, "cpu").init_params(torch.Generator()
                                                .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    out, plans = {}, {}
    for backend in BACKENDS:
        model = make_model(dataclasses.replace(cfg, gemm_backend=backend),
                           "cpu")
        PLAN_CACHE.clear()
        with events.capture() as evs, torch.inference_mode():
            logits, _ = model.prefill(params, {"tokens": tokens})
        plans[backend] = events.count(evs, "plan_build")
        res = Engine(model, params, max_new_tokens=4,
                     device="cpu").generate({"tokens": tokens})
        out[backend] = (logits, res.tokens)
    assert torch.equal(out[None][0], out["padded_baseline"][0])
    assert torch.equal(out[None][1], out["padded_baseline"][1])
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    assert plans[None] == 3 + 2 * n_moe
    assert plans["padded_baseline"] == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_loss_and_grads_match_jax(jax_params, backend):
    """One batch's loss and every weight's gradient (relative to its
    norm) against the JAX package's (its wgrad auto-resolved under the
    baseline)."""
    jparams, np_tree = jax_params
    jcfg = _jax_cfg(backend)
    jmodel = jzoo.make_model(jcfg)
    batch = JSyntheticLM(JDataConfig(batch_size=2, seq_len=32),
                         jcfg).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss,
                                                    has_aux=True))(
        jparams, batch)
    cfg = dataclasses.replace(smoke_config(NAME), gemm_backend=backend)
    model = make_model(cfg, "cpu")
    params = params_from_jax(np_tree, cfg)
    tbatch = SyntheticLM(DataConfig(batch_size=2, seq_len=32),
                         cfg).batch_at(0)
    for k in batch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(batch[k]))
    (loss, _), grads = value_and_grad(model.loss, params, tbatch)
    assert abs(float(loss) - float(jloss)) <= 5e-3, (float(loss),
                                                      float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_TOL, (tuple(g.shape), err)


def test_entry_points_on_cpu(capsys):
    """``--arch deepseek-moe-16b --smoke --device cpu`` serves and trains,
    and the loss falls."""
    res = tserve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3"])
    assert res.tokens.shape == (2, 3)
    assert f"arch={NAME}" in capsys.readouterr().out
    run = tlaunch.main(["--arch", NAME, "--smoke", "--device", "cpu",
                        "--steps", "4", "--batch", "4", "--seq", "64",
                        "--log-every", "10"])
    losses = [h["loss"] for h in run.history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
