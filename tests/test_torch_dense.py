"""The port's dense family (``qwen3-1.7b``: SwiGLU MLP, GQA 16/8,
qk-norm, tied embeddings) and the ``attn_backend="flash"`` path of both
ported models, against the JAX package on the same params.

The JAX side runs attention as its own tests run it (flash in interpret
mode on the CPU) and its fp8 GEMMs on the Pallas kernels in interpret
mode (the MLP) or the exact XLA oracles (the MoE model, as
``tests/test_torch_train.py`` does); the port runs its plain versions.
Tolerances, each with its reason:
  - MLP, bf16: both round every GEMM output to bf16, but the reference's
    ``silu(g) * u`` runs fused in f32 by XLA where PyTorch rounds each
    operation to bf16, a few bf16 steps of the largest output: 2e-2 of
    the max.
  - MLP, fp8 (fused epilogue or producer-fused): the quantizers are
    bitwise and the GEMM outputs round to bf16 in both (measured: within
    1.1e-5 of the max at these seeds), but one GEMM output an ulp apart
    can flip a whole e4m3 step (2^-3) of one activation element, about
    2^-3 / sqrt(F) of the max output: 1e-2 of the max.
  - whole models: a bf16 ulp upstream of a later rounding moves the
    logits; qwen3-1.7b (bf16) is held at 2e-2 of the largest logit and
    its greedy tokens must be equal; the fp8 MoE model at 10% as in
    ``tests/test_torch_serve.py``.  3-step loss trajectories within 2e-2,
    the first loss within 5e-3, as the MoE trajectories there.
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
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.optim import adamw as jadamw
from repro.serve.engine import Engine as JEngine
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 tree_from_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention_kernel as fk
from repro_torch.kernels.plan import KernelConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers
from repro_torch.models import attention as tattn
from repro_torch.models.model_zoo import make_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import make_train_step
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

MODELS = ("qwen3-1.7b", "qwen2-moe-a2.7b")
BATCH, PROMPT, NEW = 2, 128, 4


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_to_max(got, want):
    got = got.detach().float().numpy()
    want = _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        return {f"{prefix}/{i}{k}": s for i, t in enumerate(tree)
                for k, s in _shapes(t).items()}
    return {prefix: tuple(tree.shape)}


# ---------------------------------------------------------------------------
# configs, param counts and the param tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_param_count_is_the_tree_size(name):
    """``param_count`` equals the number of elements in the param tree: of
    the port's own smoke tree, and (by shapes alone) of the JAX package's
    full-size tree."""
    cfg = smoke_config(name)
    params = make_model(cfg, "cpu").init_params(torch.Generator()
                                                .manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(params)) == cfg.param_count()
    jmodel = jzoo.make_model(jax_get_config(name))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == \
        get_config(name).param_count()


def test_qwen3_config():
    cfg = get_config("qwen3-1.7b")
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size) == ("dense", 28, 2048, 16, 8, 128, 6144, 151936)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.moe is None
    assert cfg.precision == "bf16" and cfg.attn_backend == "chunked"
    assert abs(cfg.param_count() - 1.72e9) < 0.01e9
    jcfg = jax_get_config("qwen3-1.7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "rope_theta", "qk_norm",
              "tie_embeddings", "norm_eps", "attn_chunk"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(smoke_config("qwen3-1.7b"), f) == \
            getattr(jax_smoke_config("qwen3-1.7b"), f), f


def test_params_from_jax_carries_the_dense_tree():
    """The JAX package's dense tree (``mlp``, ``q_norm``/``k_norm``, no
    ``lm_head``) crosses to the port with the port's own structure,
    shapes and values."""
    cfg = smoke_config("qwen3-1.7b")
    jparams = jzoo.make_model(jax_smoke_config("qwen3-1.7b")).init_params(
        jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    own = make_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(own)
    assert "lm_head" not in params["embed"]
    lp = params["layers"][1]
    assert sorted(lp["mlp"]) == ["w_down", "w_gate", "w_up"]
    assert sorted(lp["attn"]) == ["k_norm", "q_norm", "wk", "wo", "wq", "wv"]
    np.testing.assert_array_equal(
        lp["mlp"]["w_gate"].float().numpy(),
        _np(jparams["layers"]["b0"]["mlp"]["w_gate"][1]))
    assert lp["mlp"]["w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("recipe,f,tol", [
    ("bf16", 512, 2e-2),
    ("fp8", 512, 1e-2),        # fused activation-quantize epilogue
    ("fp8_fused", 512, 1e-2),  # producer-fused FFN
    ("fp8", 192, 2e-2),        # widths not multiples of 128: bf16 matmuls
])
def test_mlp_matches_jax(act, recipe, f, tol):
    d = 256
    prec = "bf16" if recipe == "bf16" else "fp8"
    fused = recipe == "fp8_fused"
    p = jlayers.init_mlp(jax.random.PRNGKey(f), d, f, act, jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 24, d)),
                    jnp.bfloat16)
    jcfg = JConfig(block_m=16, backend="pallas_interpret",
                   fuse_producer=fused)
    want = jax.jit(lambda p, x: jlayers.mlp(
        p, x, act, precision=prec, backend="pallas_interpret",
        config=jcfg))(p, x)
    tp = tree_from_numpy(jax.tree.map(np.asarray, p))
    tx = torch.from_numpy(np.array(_np(x))).bfloat16()
    got = layers.mlp(tp, tx, act, precision=prec,
                     config=KernelConfig(block_m=16, fuse_producer=fused))
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert rel_to_max(got, want) <= tol


def test_mlp_gradients_flow():
    """The dense MLP trains: every weight gets a finite gradient, in bf16
    and in fp8 (the fused epilogue's autograd Function)."""
    gen = torch.Generator().manual_seed(0)
    p = layers.init_mlp(256, 256, "swiglu", torch.bfloat16, generator=gen,
                        device="cpu")
    x = torch.randn((4, 8, 256), generator=gen).bfloat16()
    for prec in ("bf16", "fp8"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        layers.mlp(leaves, x, precision=prec).float().square().sum() \
            .backward()
        for k, v in leaves.items():
            assert v.grad is not None and torch.isfinite(v.grad).all(), k


# ---------------------------------------------------------------------------
# whole models with attn_backend="flash"
# ---------------------------------------------------------------------------

def _configs(name):
    """Both packages' smoke configs of ``name`` with flash attention; the
    MoE model in fp8 on the exact XLA oracles."""
    moe = name == "qwen2-moe-a2.7b"
    jcfg = dataclasses.replace(
        jax_smoke_config(name), attn_backend="flash",
        **({"precision": "fp8", "gemm_backend": "xla_exact"} if moe else {}))
    cfg = dataclasses.replace(smoke_config(name), attn_backend="flash")
    return jcfg, cfg, 0.1 if moe else 2e-2


@pytest.fixture(scope="module", params=MODELS)
def flash_pair(request):
    jcfg, cfg, tol = _configs(request.param)
    jmodel = jzoo.make_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = make_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (BATCH, PROMPT))
    return jmodel, jparams, model, params, tokens, tol


def _counting(monkeypatch):
    calls = []
    real = tattn.flash_attention_trainable
    monkeypatch.setattr(tattn, "flash_attention_trainable",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def test_flash_prefill_and_teacher_forced_decode_logits(flash_pair,
                                                        monkeypatch):
    """Prompt 128 takes flash attention in every layer of the prefill (S %
    128 == 0), never in decode; logits against the JAX package's."""
    jmodel, jparams, model, params, tokens, tol = flash_pair
    cap = PROMPT + NEW
    jdec = jzoo.with_kernel_config(jmodel, JConfig(block_m=16,
                                                   backend="xla_exact"))
    jl, jcache = jax.jit(functools.partial(jmodel.prefill,
                                           cache_capacity=cap))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    jstep = jax.jit(jdec.decode_step)
    calls = _counting(monkeypatch)
    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    with torch.inference_mode():
        tl, tcache = engine.prefill({"tokens": torch.from_numpy(tokens)}, cap)
        assert len(calls) == model.cfg.num_layers
        assert rel_to_max(tl, jl[:, -1]) <= tol
        forced = np.random.default_rng(2).integers(0, 512, (NEW - 1, BATCH))
        for tok in forced:
            jl, jcache = jstep(jparams, jnp.asarray(tok[:, None], jnp.int32),
                               jcache)
            tl, tcache = engine.decode_step(torch.from_numpy(tok), tcache)
            assert rel_to_max(tl, jl[:, 0]) <= tol
    assert len(calls) == model.cfg.num_layers


def test_flash_greedy_generate_matches(flash_pair):
    jmodel, jparams, model, params, tokens, _ = flash_pair
    jdec = jzoo.with_kernel_config(jmodel, JConfig(block_m=16,
                                                   backend="xla_exact"))
    want = JEngine(jmodel, jparams, max_new_tokens=NEW,
                   decode_kernel_config=jdec.cfg.kernel_config).generate(
        {"tokens": jnp.asarray(tokens, jnp.int32)},
        key=jax.random.PRNGKey(0)).tokens
    res = Engine(model, params, max_new_tokens=NEW, device="cpu").generate(
        {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", MODELS)
def test_flash_loss_trajectory_matches_jax(name, monkeypatch):
    """3 AdamW steps from identical params, optimizer state and batches
    (seq 128: every layer's attention is flash in both packages)."""
    jcfg, cfg, _ = _configs(name)
    jmodel = jzoo.make_model(jcfg)
    init = jmodel.init_params(jax.random.PRNGKey(0))
    opt_kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jopt = jadamw.OptConfig(**opt_kw)
    init_state = jax.tree.map(np.asarray, jadamw.init_opt_state(init, jopt))
    jparams, jstate = init, jadamw.init_opt_state(init, jopt)
    jdata = JSyntheticLM(JDataConfig(batch_size=2, seq_len=128), jcfg)
    jstep = jax.jit(jmake_train_step(jmodel.loss, jopt))
    want = []
    for s in range(3):
        jparams, jstate, m = jstep(jparams, jstate, jdata.batch_at(s))
        want.append(float(m["loss"]))

    model = make_model(cfg, "cpu")
    data = SyntheticLM(DataConfig(batch_size=2, seq_len=128), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, init), cfg)
    state = opt_state_from_jax(init_state, cfg)
    step = make_train_step(model.loss, adamw.OptConfig(**opt_kw))
    calls = _counting(monkeypatch)
    got = []
    for s in range(3):
        params, state, m = step(params, state, data.batch_at(s))
        got.append(float(m["loss"]))
    # two flash forwards per layer per step: remat (the default)
    # recomputes each layer's forward in the backward; the backward itself
    # recomputes the oracle, not the flash forward
    assert len(calls) == 2 * 3 * cfg.num_layers
    assert abs(got[0] - want[0]) <= 5e-3, (got, want)
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert want[-1] < want[0] and got[-1] < got[0]


def test_qwen3_entry_points_on_cpu(capsys):
    """``--arch qwen3-1.7b --smoke`` serves and trains on the CPU."""
    res = tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16",
                       "--max-new", "3"])
    assert res.tokens.shape == (2, 3)
    assert "arch=qwen3-1.7b" in capsys.readouterr().out
    run = tlaunch.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "32",
                        "--lr", "3e-3", "--log-every", "10"])
    losses = [h["loss"] for h in run.history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert fk.flash_attention_cuda.launches == 0


@pytest.mark.parametrize("name", ARCHS)
def test_other_families_still_raise(name):
    """Every architecture of the zoo builds and runs a smoke forward on the
    CPU (finite logits of the expected shape); what still raises is a
    block kind outside the four the zoo knows (``ValueError``, as in the
    JAX package) and an unknown architecture (``KeyError``)."""
    from repro_torch.models.model_zoo import synthetic_batch
    cfg = smoke_config(name)
    model = make_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, 16, 2)
    with torch.inference_mode():
        logits, _ = model.prefill(params, batch, cache_capacity=32)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    if cfg.family != "audio":       # whisper has no block pattern
        unknown = dataclasses.replace(cfg, block_pattern=("attn", "mamba"))
        with pytest.raises(ValueError, match="mamba"):
            make_model(unknown, "cpu").init_params(gen)
    with pytest.raises(KeyError):
        smoke_config(name + "-x")
