"""The port's model-zoo modules against the JAX package's, at smoke width
on the same params and inputs (numpy draws from fixed seeds): windowed
attention (chunked prefill, the ring-buffer decode across its wrap, the
non-ring windowed cache), the RG-LRU block, the mLSTM and sLSTM blocks,
and ``params_from_jax`` leaf by leaf for every tree layout.

Tolerances, each with its reason:
  - bf16 outputs (attention, the blocks' y): both packages compute in f32
    and round to bf16, but the f32 sums add in another order (XLA's dot
    against PyTorch's einsum), so an output may round to the neighbouring
    bf16 value: one bf16 step, 2^-7 of the largest output
    (``BF16_STEP``); measured within 1.7e-3.
  - f32 recurrent states (RG-LRU ``h``, mLSTM ``C`` / ``n``, sLSTM ``c``
    / ``n``): the same bf16 inputs in both packages, f32 sums in another
    order (RG-LRU: the reference's associative scan is a tree, the port's
    chunks add in sequence), so 1e-5 of the largest state element, f32
    rounding over a few hundred additions; measured within 7e-7.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import rglru as jrg
from repro.models import transformer as jtfm
from repro.models import xlstm as jxl
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import params_from_jax, tree_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trg
from repro_torch.models import xlstm as txl
from repro_torch.models.model_zoo import make_model
from repro_torch.models.transformer import layer_kinds
from repro_torch.tree import tree_leaves

BF16_STEP = 2.0 ** -7
STATE_TOL = 1e-5



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


def _pair(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(_np(j))).bfloat16()


def _params(init, cfg, dtype=jnp.bfloat16, key=0):
    p = init(jax.random.PRNGKey(key), cfg, dtype)
    return p, tree_from_numpy(jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------------------
# sliding-window attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,window,q_offset", [
    (160, 32, 0),       # 3 chunks of 64: the block skip drops chunk pairs
    (100, 48, 0),       # a partial last chunk
    (64, 16, 40),       # q and k at an offset (a continued prefill)
])
def test_windowed_chunked_attention_matches_jax(sq, window, q_offset):
    qj, qt = _pair((2, sq, 4, 64), 1)
    kj, kt = _pair((2, sq, 2, 64), 2)
    vj, vt = _pair((2, sq, 2, 64), 3)
    kw = dict(causal=True, window=window, chunk=64, q_offset=q_offset,
              k_offset=q_offset)
    want = jax.jit(functools.partial(jattn.chunked_attention, **kw))(
        qj, kj, vj)
    got = tattn.chunked_attention(qt, kt, vt, **kw)
    assert rel_to_max(got, want) <= BF16_STEP
    if q_offset:
        return      # k_valid (= S) masks absolute positions in both packages
    # the window holds: the last row equals attention over its window alone
    tail = tattn.chunked_attention(qt[:, -1:], kt[:, -window:],
                                   vt[:, -window:], causal=False,
                                   window=None, chunk=64)
    torch.testing.assert_close(got[:, -1:].float(), tail.float(),
                               atol=2 * BF16_STEP, rtol=0)


def _attn_cfgs(window):
    jcfg = dataclasses.replace(jax_smoke_config("recurrentgemma-2b"),
                               window=window)
    return jcfg, dataclasses.replace(smoke_config("recurrentgemma-2b"),
                                     window=window)


@pytest.mark.parametrize("prompt,capacity,steps", [
    (40, None, 30),     # S > window: a ring of 32 slots, wrapping at 64
    (20, 80, 30),       # S <= window, capacity 80: slot = position
])
def test_windowed_decode_matches_jax_across_the_wrap(prompt, capacity,
                                                     steps):
    """Prefill, then decode steps through the JAX package's attention
    block and the port's (the ring written in place at ``len % window``):
    every step's output against JAX's, and against a windowed prefill of
    the whole sequence (the window gate of one layer)."""
    window = 32
    jcfg, cfg = _attn_cfgs(window)
    jp, tp = _params(jattn.init_attention, jcfg)
    n = prompt + steps
    xj, xt = _pair((2, n, cfg.d_model), 4)
    pos = jnp.arange(prompt, dtype=jnp.int32)
    _, jcache = jattn.attention_block(jp, xj[:, :prompt], jcfg, pos,
                                      layer_window=window, mode="prefill",
                                      cache_capacity=capacity)
    with torch.inference_mode():
        _, cache = tattn.attention_block(
            tp, xt[:, :prompt], cfg, torch.arange(prompt), mode="prefill",
            layer_window=window, cache_capacity=capacity)
        assert cache["k"].shape[1] == (window if prompt > window
                                       else capacity)
        np.testing.assert_array_equal(cache["k"].float().numpy(),
                                      _np(jcache["k"]))
        jstep = jax.jit(functools.partial(jattn.attention_block, cfg=jcfg,
                                          positions=None,
                                          layer_window=window,
                                          mode="decode"))
        outs = []
        for t in range(prompt, n):
            want, jcache = jstep(jp, xj[:, t:t + 1], cache=jcache)
            got, cache = tattn.attention_block(tp, xt[:, t:t + 1], cfg,
                                               None, cache=cache,
                                               layer_window=window,
                                               mode="decode")
            assert cache["len"] == t + 1
            assert rel_to_max(got, want) <= BF16_STEP, t
            outs.append(got)
        np.testing.assert_array_equal(cache["k"].float().numpy(),
                                      _np(jcache["k"]))
        full, _ = tattn.attention_block(tp, xt, cfg, torch.arange(n),
                                        layer_window=window)
    got = torch.cat(outs, dim=1).float()
    assert float((got - full[:, prompt:].float()).abs().max()
                 / full.float().abs().max()) <= 2 * BF16_STEP


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rglru_pair():
    cfg = jax_smoke_config("recurrentgemma-2b")
    jp, tp = _params(jrg.init_rglru, cfg)
    xj, xt = _pair((2, 150, cfg.d_model), 5)
    return jp, tp, xj, xt


def test_rglru_prefill_and_decode_match_jax(rglru_pair):
    """Prefill of 147 steps (3 chunks of the port's recurrence, the last
    partial), then 3 decode steps on the carried state."""
    jp, tp, xj, xt = rglru_pair
    s = 147
    want, jstate = jax.jit(jrg.rglru_apply)(jp, xj[:, :s])
    with torch.inference_mode():
        got, state = trg.rglru_apply(tp, xt[:, :s])
    assert rel_to_max(got, want) <= BF16_STEP
    assert state["h"].dtype == torch.float32
    assert state["conv"].dtype == torch.bfloat16
    assert rel_to_max(state["h"], jstate["h"]) <= STATE_TOL
    np.testing.assert_array_equal(state["conv"].float().numpy(),
                                  _np(jstate["conv"]))
    jdec = jax.jit(lambda p, x, st: jrg.rglru_apply(p, x, state=st))
    for t in range(s, 150):
        want, jstate = jdec(jp, xj[:, t:t + 1], jstate)
        with torch.inference_mode():
            got, state = trg.rglru_apply(tp, xt[:, t:t + 1], state=state)
        assert rel_to_max(got, want) <= BF16_STEP
        assert rel_to_max(state["h"], jstate["h"]) <= STATE_TOL


def test_rglru_chunked_prefill_carries_its_state(rglru_pair):
    """A prefill of 150 steps as 70 then 80 (the second on the carried h
    and conv state) equals the one-shot prefill, the JAX package's
    included.  (The JAX package's own conv, given a state and S > 1,
    yields one position only; ROADMAP C.)"""
    jp, tp, xj, xt = rglru_pair
    want, jstate = jax.jit(jrg.rglru_apply)(jp, xj)
    with torch.inference_mode():
        y1, st = trg.rglru_apply(tp, xt[:, :70])
        y2, st = trg.rglru_apply(tp, xt[:, 70:], state=st)
        one, st1 = trg.rglru_apply(tp, xt)
    got = torch.cat([y1, y2], dim=1)
    assert rel_to_max(got, want) <= BF16_STEP
    assert rel_to_max(st["h"], jstate["h"]) <= STATE_TOL
    assert float((got.float() - one.float()).abs().max()
                 / one.float().abs().max()) <= BF16_STEP
    torch.testing.assert_close(st["h"], st1["h"], atol=1e-6, rtol=1e-5)
    assert torch.equal(st["conv"], st1["conv"])


def test_linear_scan_forms_no_positive_exponent(monkeypatch):
    """The recurrence at strong decays (log a down to -40 a step) stays
    finite and matches a sequential f32 loop; ``exp`` never sees a
    positive argument."""
    gen = torch.Generator().manual_seed(0)
    log_a = -40.0 * torch.rand((2, 150, 8), generator=gen)
    x = torch.randn((2, 150, 8), generator=gen)
    h0 = torch.randn((2, 8), generator=gen)
    real, seen = torch.exp, []

    def spy(t):
        seen.append(float(t.max()))
        return real(t)
    monkeypatch.setattr(torch, "exp", spy)
    hs = trg.linear_scan(log_a, x, h0)
    monkeypatch.setattr(torch, "exp", real)
    assert seen and max(seen) <= 0.0
    h, want = h0, []
    for t in range(150):
        h = torch.exp(log_a[:, t]) * h + x[:, t]
        want.append(h)
    torch.testing.assert_close(hs, torch.stack(want, 1), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def test_mlstm_two_chunks_and_decode_match_jax():
    """S = 512: two chunks of 256, then one decode step on the state."""
    cfg = jax_smoke_config("xlstm-350m")
    jp, tp = _params(jxl.init_mlstm, cfg)
    assert tp["w_if"].dtype == torch.float32
    xj, xt = _pair((2, 513, cfg.d_model), 6)
    want, jstate = jax.jit(jxl.mlstm_apply)(jp, xj[:, :512])
    with torch.inference_mode():
        got, state = txl.mlstm_apply(tp, xt[:, :512])
    assert rel_to_max(got, want) <= BF16_STEP
    for k in ("C", "n"):
        assert rel_to_max(state[k], jstate[k]) <= STATE_TOL, k
    want, jstate = jax.jit(lambda p, x, st: jxl.mlstm_apply(p, x, state=st))(
        jp, xj[:, 512:], jstate)
    with torch.inference_mode():
        got, state = txl.mlstm_apply(tp, xt[:, 512:], state=state)
    assert rel_to_max(got, want) <= BF16_STEP
    for k in ("C", "n"):
        assert rel_to_max(state[k], jstate[k]) <= STATE_TOL, k


def test_mlstm_chunk_rule_is_enforced():
    """S % min(256, S) == 0, as the JAX package asserts; never padded."""
    cfg = smoke_config("xlstm-350m")
    p = txl.init_mlstm(cfg, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    x = torch.zeros((1, 300, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S % min"):
        txl.mlstm_apply(p, x)
    y, _ = txl.mlstm_apply(p, x[:, :127])        # one chunk of 127
    assert y.shape == (1, 127, cfg.d_model)


def test_slstm_matches_jax():
    cfg = jax_smoke_config("xlstm-350m")
    jp, tp = _params(jxl.init_slstm, cfg)
    xj, xt = _pair((2, 65, cfg.d_model), 7)
    want, jstate = jax.jit(jxl.slstm_apply)(jp, xj[:, :64])
    with torch.inference_mode():
        got, state = txl.slstm_apply(tp, xt[:, :64])
    assert rel_to_max(got, want) <= BF16_STEP
    for k in ("c", "n"):
        assert rel_to_max(state[k], jstate[k]) <= STATE_TOL, k
    want, jstate = jax.jit(lambda p, x, st: jxl.slstm_apply(p, x, state=st))(
        jp, xj[:, 64:], jstate)
    with torch.inference_mode():
        got, state = txl.slstm_apply(tp, xt[:, 64:], state=state)
    assert rel_to_max(got, want) <= BF16_STEP
    for k in ("c", "n"):
        assert rel_to_max(state[k], jstate[k]) <= STATE_TOL, k


# ---------------------------------------------------------------------------
# params_from_jax, every tree layout
# ---------------------------------------------------------------------------

def _jax_layers(np_tree, jcfg):
    """The JAX tree's blocks in layer order, read by the reference's own
    ``_layout``: pre, each cycle's b0..b{p-1}, tail."""
    pattern, n_pre, cycles, tail = jtfm._layout(jcfg)
    out = [("attn", np_tree[f"pre{i}"]) for i in range(n_pre)]
    for c in range(cycles):
        out += [(kind, jax.tree.map(lambda a: a[c],
                                    np_tree["layers"][f"b{i}"]))
                for i, kind in enumerate(pattern)]
    return out + [(kind, np_tree[f"tail{i}"]) for i, kind in enumerate(tail)]


LAYOUTS = {
    # 1 cycle (rglru, rglru, attn) and a tail (rglru, rglru)
    "hybrid_tail": ("recurrentgemma-2b", {"num_layers": 5}),
    # 2 cycles of (mlstm, slstm): two kinds stacked side by side
    "ssm_cycles": ("xlstm-350m", {}),
    # 1 cycle of the 6-block pattern, tail (mlstm, mlstm)
    "ssm_tail": ("xlstm-350m", {"num_layers": 8, "block_pattern": (
        "mlstm", "mlstm", "slstm", "mlstm", "mlstm", "slstm")}),
    "vlm": ("pixtral-12b", {}),
    "dense_bias": ("qwen1.5-110b", {}),
    "moe_pre": ("deepseek-moe-16b", {}),
    "audio": ("whisper-tiny", {}),
}


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, t in enumerate(tree)
                for p in _leaf_paths(t, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_params_from_jax_every_layout_leaf_by_leaf(layout):
    """Every leaf of the converted tree equals its JAX leaf (value, shape,
    dtype: f32 leaves stay f32), each layer taken from the JAX block of
    its position; the structure is the port's own init's."""
    name, repl = LAYOUTS[layout]
    jcfg = dataclasses.replace(jax_smoke_config(name), **repl)
    cfg = dataclasses.replace(smoke_config(name), **repl)
    jparams = jzoo.make_model(jcfg).init_params(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_tree, cfg)
    own = make_model(cfg, "cpu").init_params(torch.Generator()
                                             .manual_seed(0))
    assert _leaf_paths(params) == _leaf_paths(own)
    for a, b in zip(tree_leaves(params), tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype

    def same(got, want):
        assert sorted(got) == sorted(want)
        for k in got:
            if isinstance(got[k], dict):
                same(got[k], want[k])
            else:
                w = np.asarray(want[k])
                assert str(got[k].dtype).endswith(
                    {"float32": "float32", "bfloat16": "bfloat16"}[
                        w.dtype.name])
                np.testing.assert_array_equal(got[k].float().numpy(),
                                              w.astype(np.float32))
    for k in ("embed", "final_norm", "vision_proj", "enc_final_norm"):
        assert (k in params) == (k in np_tree)
        if k in np_tree:
            same({k: params[k]}, {k: np_tree[k]})
    if cfg.family == "audio":
        for key in ("enc_layers", "layers"):
            assert len(params[key]) == len(jax.tree.leaves(
                np_tree[key])[0])
            for i, lp in enumerate(params[key]):
                same(lp, jax.tree.map(lambda a: a[i], np_tree[key]))
        return
    want = _jax_layers(np_tree, jcfg)
    assert [k for k, _ in want] == layer_kinds(cfg)
    assert len(params["layers"]) == len(want)
    for lp, (_, wp) in zip(params["layers"], want):
        same(lp, wp)


# ---------------------------------------------------------------------------
# the presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_presets_copy_the_reference_field_for_field(name):
    """Every field the two ``ModelConfig``s share is equal, in the full and
    the smoke config, and so are the run hints; the presets keep the
    reference's bf16 but for the two MoE models the port serves in fp8
    (ROADMAP C)."""
    import repro.configs as jconfigs
    from repro_torch import configs
    shared = [f.name for f in dataclasses.fields(configs.ModelConfig)
              if f.name in {g.name for g in dataclasses.fields(
                  jconfigs.ModelConfig)} and f.name not in (
                  "dtype", "precision", "moe", "kernel_config")]
    for mine, ref in ((configs.get_config(name), jconfigs.get_config(name)),
                      (smoke_config(name), jax_smoke_config(name))):
        for f in shared:
            assert getattr(mine, f) == getattr(ref, f), f
        assert (mine.moe is None) == (ref.moe is None)
        if mine.moe is not None:
            assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
        assert mine.dtype == torch.bfloat16
        fp8 = name in ("qwen2-moe-a2.7b", "deepseek-moe-16b")
        assert mine.precision == ("fp8" if fp8 else ref.precision)
    assert configs.run_hints(name) == jconfigs.run_hints(name)


@pytest.mark.parametrize("layout", ["hybrid_tail", "ssm_cycles", "audio"])
def test_opt_state_from_jax_every_layout(layout):
    """The JAX package's AdamW state (m, v, f32 master, int8 residuals)
    crosses into the port's structure: equal, leaf by leaf, to the state
    the port's own ``init_opt_state`` builds for the converted params
    (the master copy carries their values)."""
    from repro.optim import adamw as jadamw
    from repro_torch.convert import opt_state_from_jax
    from repro_torch.optim import adamw
    name, repl = LAYOUTS[layout]
    jcfg = dataclasses.replace(jax_smoke_config(name), **repl)
    cfg = dataclasses.replace(smoke_config(name), **repl)
    jparams = jzoo.make_model(jcfg).init_params(jax.random.PRNGKey(0))
    kw = dict(use_master=True, compress_grads=True)
    jstate = jadamw.init_opt_state(jparams, jadamw.OptConfig(**kw))
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    own = adamw.init_opt_state(params, adamw.OptConfig(**kw))
    assert sorted(state) == sorted(own)
    assert _leaf_paths(state) == _leaf_paths(own)
    for a, b in zip(tree_leaves(state), tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
