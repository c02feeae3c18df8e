"""Tensor parallelism of the recurrent and audio families (the RG-LRU
block, both xLSTM blocks, whisper's self- and cross-attention, its GELU
MLP and its cross K/V cache) on gloo ranks of this machine (CPU, plain
kernel versions, f32), spawned through
``repro_torch.launch.ranks.run_ranks``: one 4-rank run (a module
fixture) holds every case, under a model axis of 4 ((1, 4)) and of 2
beside data parallelism 2 ((2, 2)).  As in ``tests/test_torch_tp.py``,
the sharded math is held against the port's one-process math, which
``tests/test_torch_zoo_*.py`` hold against the JAX package.

Against one process, within 1e-5 (of the largest logit, of the loss, of
each gathered gradient leaf's largest element, of each gathered state's
largest element): the logits of a training forward, the loss, every
gathered gradient, and the recurrent states and cross K/V a prefill
leaves; then a greedy generate of 5 tokens through the serving engine:
tokens equal, each step's logits, teacher-forced on them, within 2e-4 of
the largest (the attention caches hold bf16, as in the TP file), as are
the states after the last decode step, which read those caches.  The
cases:

- recurrentgemma-2b: on (1, 4) its 2 q heads do not divide the axis, so
  attention runs whole on every rank beside the split RG-LRU width (32
  channels a rank) and MLP; on (2, 2) a q head a rank, its one kv head
  whole;
- xlstm-350m with 4 heads of 32 (the smoke config has 2): a head of
  each mLSTM and 32 sLSTM channels a rank on (1, 4), twice that on
  (2, 2);
- whisper-tiny: a head a rank of each attention on (1, 4), 2 on (2, 2),
  the cross K/V cached by head.

The leaves every rank holds whole (the RG-LRU's ``conv``, ``lam``,
``w_a``, ``w_i``, the xLSTM's ``w_if``, ``w_og``, ``w_z``, the norms)
get bitwise equal gradients on every rank of the model axis.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.models.transformer import storage_specs
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_paths

TOL = 1e-5
DECODE_TOL = 2e-4        # the bf16 attention caches (tests/test_torch_tp.py)
SEQ, BATCH, NEW = 32, 2, 5
ARCHS = {
    "rg": ("recurrentgemma-2b", {}),
    "xlstm": ("xlstm-350m", {"num_heads": 4, "num_kv_heads": 4,
                             "head_dim": 32}),
    "whisper": ("whisper-tiny", {}),
}
CASES = {f"{a}_{m[0]}x{m[1]}": (a, m) for a in ARCHS
         for m in ((1, 4), (2, 2))}


def _cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(smoke_config(arch), dtype=torch.float32, **kw)


def _inputs(cfg):
    return synthetic_batch(torch.Generator().manual_seed(0), cfg, SEQ, BATCH)


def _states(cache, group):
    """Every recurrent state and cross K/V of ``cache``, gathered over
    ``group`` where the ranks hold a part (None: one process)."""
    from repro_torch.distributed import context as dctx
    dims = {"h": -1, "conv": -1, "C": 1, "n": None, "c": -1}
    out = {}
    for i, layer in enumerate(cache["layers"]):
        for name, x in layer.items():
            if name == "xkv":
                for j, t in enumerate(x):
                    out[f"{i}/xkv{j}"] = t if group is None else \
                        dctx.all_gather(t, 2, group)
                continue
            if name not in dims:
                continue
            dim = dims[name]
            if name == "n":          # mLSTM [B, H, D] or sLSTM [B, d]
                dim = 1 if x.dim() == 3 else -1
            out[f"{i}/{name}"] = x if group is None else \
                dctx.all_gather(x, dim, group)
    return {k: v.numpy().copy() for k, v in out.items()}


def _generate(model, params, batch, group=None):
    """Greedy tokens, each step's logits teacher-forced on them, and the
    states after the prefill and after the last decode step."""
    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    tokens = engine.generate(batch).tokens
    with torch.inference_mode():
        last, cache = engine.prefill(batch, SEQ + NEW)
        first = _states(cache, group)
        logits = [last]
        for i in range(NEW - 1):
            lg, cache = engine.decode_step(tokens[:, i], cache)
            logits.append(lg)
        end = _states(cache, group)
    return tokens, torch.stack(logits, 1), first, end


def _logits(model, params, batch):
    cfg, kw = model.cfg, dict(mesh=model.mesh)
    with torch.no_grad():
        if cfg.family == "audio":
            from repro_torch.models.whisper import whisper_forward
            return whisper_forward(params, batch["tokens"], batch["frames"],
                                   cfg, **kw)[0]
        from repro_torch.models.transformer import decoder_forward
        return decoder_forward(params, batch["tokens"], cfg, **kw)[0]


def _case(cfg, mesh):
    from repro_torch.distributed import context as dctx
    from repro_torch.models.transformer import tp_split
    from repro_torch.train.trainer import make_grad_fn
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(1))
    batch = _inputs(cfg)
    group = mesh.group("model")
    logits = _logits(model, params, batch)
    if tp_split(cfg, mesh.shape["model"])["vocab"]:
        logits = dctx.all_gather(logits, -1, group)
    (loss, _), grads = make_grad_fn(model.loss, mesh=mesh)(params, batch)
    specs = storage_specs(params, cfg, mesh)
    whole = {p: g.numpy().copy() for p, g in tree_paths(grads)
             if not sharding.spec_axes(specs[p])}
    full = sharding.gather_tree(grads, specs, mesh)
    tokens, steps, first, end = _generate(model, params, batch, group)
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": {p: g.numpy() for p, g in tree_paths(full)},
            "whole": whole, "tokens": tokens.numpy(), "steps": steps.numpy(),
            "prefill_states": first, "end_states": end,
            "coords": mesh.coords}


def _rank(rank, world):
    meshes = {}
    out = {}
    for name, (arch, sizes) in CASES.items():
        if sizes not in meshes:
            meshes[sizes] = tmesh.make_mesh(sizes, ("data", "model"))
        out[name] = _case(_cfg(arch), meshes[sizes])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank, 4, store_dir=str(tmp_path_factory.mktemp("tpr")),
                     timeout=300)


@pytest.fixture(scope="module")
def single():
    """Each arch's one-process run (one intra-op thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name in ARCHS:
            cfg = _cfg(name)
            model = make_model(cfg, "cpu")
            params = model.init_params(torch.Generator().manual_seed(1))
            batch = _inputs(cfg)
            logits = _logits(model, params, batch)
            (loss, _), grads = value_and_grad(model.loss, params, batch)
            tokens, steps, first, end = _generate(model, params, batch)
            out[name] = {"logits": logits.numpy(), "loss": float(loss),
                         "grads": {p: g.numpy()
                                   for p, g in tree_paths(grads)},
                         "tokens": tokens.numpy(), "steps": steps.numpy(),
                         "prefill_states": first, "end_states": end}
        return out
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_one_process(ranks, single, name):
    want = single[CASES[name][0]]
    for r, res in enumerate(x[name] for x in ranks):
        assert _rel(res["logits"], want["logits"]) <= TOL, (name, r)
        assert abs(res["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert set(res["grads"]) == set(want["grads"])
        for path, g in res["grads"].items():
            assert _rel(g, want["grads"][path]) <= TOL, (name, r, path)


@pytest.mark.parametrize("name", list(CASES))
def test_serve_states_match_one_process(ranks, single, name):
    want = single[CASES[name][0]]
    assert want["prefill_states"]
    for r, res in enumerate(x[name] for x in ranks):
        assert np.array_equal(res["tokens"], want["tokens"]), (name, r)
        assert _rel(res["steps"], want["steps"]) <= DECODE_TOL, (name, r)
        for key in ("prefill_states", "end_states"):
            assert set(res[key]) == set(want[key])
            for k, v in res[key].items():
                assert v.shape == want[key][k].shape, (name, key, k)
                tol = TOL if key == "prefill_states" else DECODE_TOL
                assert _rel(v, want[key][k]) <= tol, (name, r, key, k)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_take_equal_gradients(ranks, name):
    res = [x[name] for x in ranks]
    assert res[0]["whole"]
    for x in res[1:]:
        if x["coords"]["data"] != res[0]["coords"]["data"]:
            continue
        for path, g in x["whole"].items():
            assert np.array_equal(g, res[0]["whole"][path]), (name, path)


@pytest.mark.parametrize("name", list(ARCHS))
def test_recurrent_leaves_split_as_the_rules_say(name):
    """Under a model axis of 4, the leaves the rules split (``w_x``,
    ``w_y``, ``w_out``; the xLSTM's ``wq``/``wk``/``wv``/``wo``; whisper's
    attention and MLP) are split as the rules split them, and the ones
    they keep whole stay whole."""
    cfg = _cfg(name)
    mesh = tmesh.make_mesh((1, 4), ("data", "model"), with_groups=False)
    params = make_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    specs = storage_specs(params, cfg, mesh)
    ref = sharding.build_param_specs(params, mesh)
    never = ("conv", "lam", "w_a", "w_i", "w_if", "w_og", "w_z", "scale")
    split = {p for p, s in specs.items() if sharding.spec_axes(s)}
    for p in specs:
        leaf = p.rsplit("/", 1)[-1]
        if leaf in never:
            assert p not in split, p
    kinds = {"rg": ("rglru/w_x", "rglru/w_y", "rglru/w_out", "mlp/w_up"),
             "xlstm": ("mlstm/wq", "mlstm/wk", "mlstm/wo", "slstm/wo"),
             "whisper": ("xattn/wq", "xattn/wk", "attn/wo", "mlp/w_down")}
    hits = [p for p in split if p.endswith(kinds[name])]
    assert len(hits) >= len(kinds[name]), hits
    for p in hits:
        assert specs[p] + (None,) * (len(ref[p]) - len(specs[p])) == ref[p]
