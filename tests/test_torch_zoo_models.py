"""The port's whole models of the dense and VLM architectures added to
the zoo (yi-9b, minitron-8b, qwen1.5-110b, pixtral-12b) against the JAX
package's, at the smoke configs on the same params (JAX's, through
``params_from_jax``) and the same numpy inputs: prefill and decode
logits along the port's greedy tokens, one batch's loss and every
weight's gradient; the VLM engine's cache capacity; the entry points on
the CPU.  ``tests/test_torch_zoo_recurrent.py`` does the same for the
recurrent and encoder-decoder architectures with the helpers here.

Tolerances, each with its reason:
  - logits, bf16: the two packages' attention and projections round to
    bf16 an ulp apart on some elements (another f32 summation order),
    and later layers carry that on: 2e-2 of the largest logit, as
    ``tests/test_torch_dense.py`` holds qwen3-1.7b (measured: within
    1.5e-2); each greedy token JAX's argmax on the same tokens, or
    within that bound of it.
  - logits, fp8: a bf16 ulp upstream of an e4m3 quantization becomes
    whole e4m3 steps (2^-3 of a value): 10% of the largest logit, as the
    fp8 MoE model in ``tests/test_torch_serve.py`` (measured: 4.5%).
  - the loss of one batch within 5e-3 (the first loss of the
    trajectories of ``tests/test_torch_train.py``; measured: within
    1.8e-3); each weight's gradient within 8% of its norm: the backward
    runs through the same bf16 activations an ulp apart (measured: within
    2.2% on this batch, 4.4% on another, xlstm's f32 gate projection
    ``w_if``).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model_zoo as jzoo
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model_zoo import make_model
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_leaves

DENSE_ARCHS = ("yi-9b", "minitron-8b", "qwen1.5-110b", "pixtral-12b")
BATCH, NEW, PROMPT = 2, 4, 64
TOL, TOL_FP8, LOSS_TOL, GRAD_TOL = 2e-2, 0.1, 5e-3, 0.08


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's ops while this file runs: the
    smoke shapes gain nothing from more, and beside the other test
    workers PyTorch's thread pool oversubscribes the cores (measured: an
    entry-point test 0.2 s alone, 46 s beside five busy processes, 0.8 s
    there on one thread).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_to_max(got, want):
    got = got.detach().float().numpy()
    want = _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(cfg, prompt, seed=1):
    """The same prompt batch for both packages: tokens, and frames or
    patch embeddings (bf16 values)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, prompt))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    extra = {"audio": ("frames", (cfg.encoder_seq, cfg.d_model)),
             "vlm": ("patch_embeds", (cfg.num_patches, cfg.patch_embed_dim))}
    if cfg.family in extra:
        key, shape = extra[cfg.family]
        a = jnp.asarray(rng.standard_normal((BATCH, *shape)), jnp.bfloat16)
        jb[key] = a
        tb[key] = torch.from_numpy(np.array(_np(a))).bfloat16()
    return jb, tb


def _pair(name, jrepl=None, repl=None):
    jcfg = dataclasses.replace(jax_smoke_config(name), **(jrepl or {}))
    cfg = dataclasses.replace(smoke_config(name), **(repl or {}))
    jmodel = jzoo.make_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = make_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jmodel, jparams, model, params


def _cap(cfg, prompt):
    return prompt + NEW + (cfg.num_patches if cfg.family == "vlm" else 0)


def _prefill_and_decode(jmodel, jparams, model, params, prompt, tol):
    """The port's greedy generate, then both packages' prefill and NEW - 1
    decode steps fed the port's greedy tokens: every step's logits within
    ``tol`` of the largest of JAX's, and every greedy token JAX's argmax
    on the same tokens or within ``tol`` of the largest logit of it (a
    near-tie).  At this seed two tokens differ from JAX's argmax:
    qwen1.5-110b's row 1 at step 2 picks one of two tokens whose JAX
    bf16 logits are equal (JAX's argmax takes the lower index), and
    xlstm-350m's row 1 at step 0 one 0.5% of the largest logit below
    JAX's top.  Returns the port's cache after the steps."""
    cfg = model.cfg
    jb, tb = _inputs(cfg, prompt)
    cap = _cap(cfg, prompt)
    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    toks = engine.generate(tb).tokens.numpy()
    jl, jcache = jax.jit(functools.partial(jmodel.prefill,
                                           cache_capacity=cap))(jparams, jb)
    jl = jl[:, -1]
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        tl, cache = engine.prefill(tb, cap)
        for t in range(NEW):
            assert rel_to_max(tl, jl) <= tol, (t, rel_to_max(tl, jl))
            logits = _np(jl)
            gap = (logits.max(-1) - logits[np.arange(BATCH), toks[:, t]]) \
                / np.abs(logits).max(-1)
            assert (gap <= tol).all(), (t, gap)
            if t + 1 < NEW:
                tok = toks[:, t]
                jl, jcache = jstep(jparams, jnp.asarray(tok[:, None],
                                                        jnp.int32), jcache)
                jl = jl[:, 0]
                tl, cache = engine.decode_step(torch.from_numpy(tok), cache)
    return cache


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_prefill_decode_and_greedy_tokens_match_jax(name):
    _prefill_and_decode(*_pair(name), PROMPT, TOL)


def check_loss_and_grads(name):
    """One batch of the data pipeline (bitwise the JAX package's, frames
    and patch embeddings included): the loss, and every weight's gradient
    relative to its norm, against the JAX package's."""
    jmodel, jparams, model, params = _pair(name)
    cfg = model.cfg
    seq = 64
    jbatch = JSyntheticLM(JDataConfig(batch_size=2, seq_len=seq),
                          jax_smoke_config(name)).batch_at(0)
    tbatch = SyntheticLM(DataConfig(batch_size=2, seq_len=seq),
                         cfg).batch_at(0)
    assert sorted(tbatch) == sorted(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss,
                                                    has_aux=True))(
        jparams, jbatch)
    (loss, _), grads = value_and_grad(model.loss, params, tbatch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL, (float(loss),
                                                          float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= GRAD_TOL, (tuple(g.shape), err)


@pytest.mark.parametrize("name", DENSE_ARCHS)
def test_loss_and_grads_match_jax(name):
    check_loss_and_grads(name)


def test_vlm_engine_cache_holds_the_patches():
    """The engine's capacity counts the patch positions: the caches hold
    num_patches + prompt + max_new slots and positions run over both."""
    cfg = smoke_config("pixtral-12b")
    model = make_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    _, tb = _inputs(cfg, 16)
    seen = []
    real = model.prefill

    def spy(p, batch, cache_capacity=None):
        seen.append(cache_capacity)
        return real(p, batch, cache_capacity=cache_capacity)
    model = dataclasses.replace(model, prefill=spy)
    res = Engine(model, params, max_new_tokens=3, device="cpu").generate(tb)
    assert seen == [cfg.num_patches + 16 + 3]
    assert res.tokens.shape == (BATCH, 3)


def check_entry_points(name, capsys):
    """``--arch <name> --smoke --device cpu`` serves and trains (batches
    carry frames or patch embeddings), and the loss falls."""
    res = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3"])
    assert res.tokens.shape == (2, 3)
    assert f"arch={name}" in capsys.readouterr().out
    run = tlaunch.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "32",
                        "--lr", "3e-3", "--log-every", "10"])
    losses = [h["loss"] for h in run.history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_entry_points_on_cpu(capsys):
    check_entry_points("pixtral-12b", capsys)
