"""Tensor parallelism of the attention families (attention heads, the
SwiGLU MLP, the vocab-parallel embedding, head and loss, and the decode
caches split over their slots) on gloo ranks of this machine (CPU, plain
kernel versions, f32), spawned through
``repro_torch.launch.ranks.run_ranks``: one 4-rank run (a module
fixture) holds every case below, then 2 ranks restore its checkpoint.
The reference's own multi-device tests fail (ROADMAP C), so, as for the
MoE layer, the port's sharded math is held against its one-process math,
which the other files hold against the JAX package.

Against one process, within 1e-5 (of the largest logit, of the loss, of
each gathered gradient leaf's largest element): the logits of a training
forward, the loss and every gathered gradient; then a greedy generate of
5 tokens through the serving engine, the caches split over their slots:
tokens equal, and each step's logits, teacher-forced on the same tokens,
within 2e-4 of the largest.  The caches hold bf16, as the reference's,
whatever the model's dtype, so a k or v that one process and the ranks
compute an f32 ulp apart may round to bf16 one step apart (the steps
read 1.9e-5 to 6.0e-5 here); the split attention itself is held at 1e-6
against the whole cache's on the same bf16 cache.  The cases:

- qwen3-1.7b on (1, 4): 1 q head a rank over 2 kv heads, which do not
  divide the axis and stay whole (each rank reads its q head's), qk-norm,
  tied embeddings (the vocab-parallel head is the embedding's slice);
- qwen3-1.7b and pixtral-12b on (2, 2): TP 2 (1 kv head a rank) beside
  data parallelism 2; pixtral's patch projection stays whole;
- qwen2-moe-a2.7b on (1, 4): QKV biases, the MoE layers under EP beside
  the heads, with the dense (GShard) dispatch, whose expert products are
  f32 here: the ragged bf16 recipe rounds the grouped GEMMs' operands to
  bf16, which turns the ranks' f32 reassociation into bf16 steps (its EP
  logits sat 3.9e-5 from one process's before the heads were split).

The leaves every rank holds whole (norms, the router, the qk-norm
scales, ``vision_proj``) get bitwise equal gradients on every rank of
the model axis.  The vocab-parallel cross-entropy on its own, logits
with ignored labels: loss and gradient within 1e-5 of one process's.  A
cache whose slots the axis does not divide (a 38-slot capacity on 4
ranks) stays whole and decodes the same tokens.  The raise: an fp8 MLP
whose 4-way slice is no multiple of 128 (d_ff 768 -> 192).  The storage
specs of every dense leaf, of every arch, are the partition rules' where
the heads (widths, channels) divide the axis (the rules themselves are
held against the JAX package's in ``tests/test_torch_mesh.py``), whole
otherwise; the recurrent and audio families run in
``tests/test_torch_tp_recurrent.py``.  A
checkpoint of a (1, 4) train step restores onto (1, 2) bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import layers
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.models.transformer import storage_specs
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5
# decode logits, of the largest: the caches hold bf16, so the ranks' and
# one process's attention round differently; about 3x the largest reading
# on these cases (6.0e-5, pixtral on (2, 2))
DECODE_TOL = 2e-4
SEQ, BATCH, NEW = 32, 2, 5
CASES = {
    # name: (arch, mesh sizes, config fields)
    "qwen3_1x4": ("qwen3-1.7b", (1, 4), {}),
    "qwen3_2x2": ("qwen3-1.7b", (2, 2), {}),
    "pixtral_2x2": ("pixtral-12b", (2, 2), {}),
    "qwen2moe_1x4": ("qwen2-moe-a2.7b", (1, 4), {"precision": "bf16",
                                                 "moe_dispatch": "dense"}),
}


def _cfg(arch, **kw):
    return dataclasses.replace(smoke_config(arch), dtype=torch.float32,
                               **kw)


def _inputs(cfg):
    gen = torch.Generator().manual_seed(0)
    batch = synthetic_batch(gen, cfg, SEQ, BATCH)
    return batch


def _generate(model, params, batch, cap=None):
    """The engine's greedy tokens, and each step's logits teacher-forced
    on them (prefill, then the decode steps)."""
    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    tokens = engine.generate(batch).tokens
    extra = model.cfg.num_patches if model.cfg.family == "vlm" else 0
    with torch.inference_mode():
        last, cache = engine.prefill(batch, cap or SEQ + extra + NEW)
        logits = [last]
        for i in range(NEW - 1):
            lg, cache = engine.decode_step(tokens[:, i], cache)
            logits.append(lg)
    return tokens, torch.stack(logits, 1)


def _rank(rank, world, ckpt_dir):
    """Every 4-rank case; then a (1, 4) train step saved to ``ckpt_dir``;
    the fp8 raise; the vocab-parallel loss; a cache left whole."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.distributed import context as dctx
    out = {}
    meshes = {}
    for name, (arch, sizes, kw) in CASES.items():
        if sizes not in meshes:
            meshes[sizes] = tmesh.make_mesh(sizes, ("data", "model"))
        mesh = meshes[sizes]
        out[name] = _case(_cfg(arch, **kw), mesh)

    # a train step on (1, 4), checkpointed, with the next batch's loss
    mesh = meshes[(1, 4)]
    cfg = _cfg("qwen3-1.7b")
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(2))
    opt_cfg = adamw.OptConfig(use_master=False)
    opt = adamw.init_opt_state(params, opt_cfg)
    pspecs = storage_specs(params, cfg, mesh)
    step = make_train_step(model.loss, opt_cfg, mesh=mesh, specs=pspecs)
    params, opt, _ = step(params, opt, _inputs(cfg))
    state = {"params": params, "opt": opt}
    specs = sharding.tree_specs(state, pspecs)
    ckpt.save(ckpt_dir, 0, state, mesh=mesh, specs=specs)
    out["saved"] = _restored_view(model, state, specs, mesh)

    # fp8: a d_ff whose 4-way slice is no multiple of 128 raises
    cfg = dataclasses.replace(smoke_config("yi-9b"), d_ff=768,
                              precision="fp8")
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(0))
    try:
        model.loss(params, _inputs(cfg))
        out["fp8_raise"] = None
    except ValueError as e:
        out["fp8_raise"] = str(e)

    # the vocab-parallel loss on its own
    g = dctx.model_axis_size(mesh)
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(
        np.float32) * 4)
    labels = torch.from_numpy(rng.integers(-1, 64, (2, 7)))
    w = full.shape[-1] // g
    part = full[..., mesh.coord("model") * w:(mesh.coord("model") + 1) * w]
    part = part.clone().requires_grad_()
    loss = layers.cross_entropy(part, labels, mesh.group("model"))
    (grad,) = torch.autograd.grad(loss, part)
    out["ce"] = (float(loss), grad.numpy())

    # the split attention against the whole cache's, on one bf16 cache
    from repro_torch.models import attention as attn
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((2, 1, 8, 64), generator=gen)
    kc, vc = (torch.randn((2, 24, 2, 64), generator=gen).to(torch.bfloat16)
              for _ in range(2))
    mask = torch.arange(24) <= 13
    lo = mesh.coord("model") * 6
    out["split_attention"] = (
        attn._attend_cache_split(q, kc[:, lo:lo + 6], vc[:, lo:lo + 6],
                                 mask[lo:lo + 6],
                                 mesh.group("model")).numpy(),
        attn._attend_cache(q, kc, vc, mask).numpy())

    # 38 cache slots on 4 ranks: the cache stays whole
    cfg = _cfg("yi-9b")
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(1))
    out["whole_cache"] = _generate(model, params, _inputs(cfg),
                                   cap=SEQ + 6)[0].numpy()
    return out


def _restored_view(model, state, specs, mesh):
    """The gathered state and the next batch's loss."""
    full = sharding.gather_tree(state, specs, mesh)
    batch = synthetic_batch(torch.Generator().manual_seed(5), model.cfg,
                            SEQ, BATCH)
    with torch.no_grad():
        loss = float(model.loss(state["params"], batch)[0])
    return {"state": [x.numpy() for x in tree_leaves(full)], "loss": loss}


def _case(cfg, mesh):
    from repro_torch.models.transformer import decoder_forward
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(1))
    batch = _inputs(cfg)
    group = mesh.group("model")
    from repro_torch.distributed import context as dctx
    from repro_torch.train.trainer import make_grad_fn
    with torch.no_grad():
        logits = decoder_forward(params, batch["tokens"], cfg,
                                 patch_embeds=batch.get("patch_embeds"),
                                 mesh=mesh)[0]
    logits = dctx.all_gather(logits, -1, group)
    (loss, _), grads = make_grad_fn(model.loss, mesh=mesh)(params, batch)
    specs = storage_specs(params, cfg, mesh)
    # the leaves every rank holds whole: their gradients as each rank has
    # them, to compare across the ranks
    whole = {p: g.numpy().copy() for (p, g) in tree_paths(grads)
             if all(a is None for a in specs[p])}
    full = sharding.gather_tree(grads, specs, mesh)
    tokens, steps = _generate(model, params, batch)
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": {p: g.numpy() for p, g in tree_paths(full)},
            "whole": whole, "tokens": tokens.numpy(),
            "steps": steps.numpy(), "coords": mesh.coords,
            "local_wk": tuple(params["layers"][0]["attn"]["wk"].shape)}


def _restore_rank(rank, world, ckpt_dir):
    from repro_torch.checkpoint import checkpointer as ckpt
    mesh = tmesh.make_mesh((1, world), ("data", "model"))
    cfg = _cfg("qwen3-1.7b")
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(9))
    opt = adamw.init_opt_state(params, adamw.OptConfig(use_master=False))
    state = {"params": params, "opt": opt}
    specs = sharding.tree_specs(state, storage_specs(params, cfg, mesh))
    _, _, s = ckpt.restore_latest(ckpt_dir, state, mesh=mesh, specs=specs)
    assert s == 0
    return _restored_view(model, state, specs, mesh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    ckpt_dir = str(d / "ckpt")
    four = run_ranks(_rank, 4, store_dir=str(d), timeout=240,
                     args=(ckpt_dir,))
    two = run_ranks(_restore_rank, 2, store_dir=str(d), timeout=120,
                    args=(ckpt_dir,))
    return {"four": four, "two": two}


@pytest.fixture(scope="module")
def single():
    """Each case's one-process run (one intra-op thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (arch, sizes, kw) in CASES.items():
            cfg = _cfg(arch, **kw)
            model = make_model(cfg, "cpu")
            params = model.init_params(torch.Generator().manual_seed(1))
            batch = _inputs(cfg)
            from repro_torch.models.transformer import decoder_forward
            with torch.no_grad():
                logits = decoder_forward(
                    params, batch["tokens"], cfg,
                    patch_embeds=batch.get("patch_embeds"))[0]
            (loss, _), grads = value_and_grad(model.loss, params, batch)
            tokens, steps = _generate(model, params, batch)
            out[name] = {"logits": logits.numpy(), "loss": float(loss),
                         "grads": {p: g.numpy()
                                   for p, g in tree_paths(grads)},
                         "tokens": tokens.numpy(), "steps": steps.numpy()}
        cfg = _cfg("yi-9b")
        model = make_model(cfg, "cpu")
        params = model.init_params(torch.Generator().manual_seed(1))
        out["whole_cache"] = _generate(model, params, _inputs(cfg),
                                       cap=SEQ + 6)[0].numpy()
        return out
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_matches_one_process(ranks, single, name):
    want = single[name]
    for r, res in enumerate(x[name] for x in ranks["four"]):
        assert _rel(res["logits"], want["logits"]) <= TOL, (name, r)
        assert abs(res["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert set(res["grads"]) == set(want["grads"])
        for path, g in res["grads"].items():
            assert _rel(g, want["grads"][path]) <= TOL, (name, r, path)
        assert np.array_equal(res["tokens"], want["tokens"]), (name, r)
        assert _rel(res["steps"], want["steps"]) <= DECODE_TOL, (name, r)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_take_equal_gradients(ranks, name):
    """Each rank's gradient of a leaf it holds whole is the whole
    gradient, bitwise the same on every rank of the model axis (the
    ``copy_to`` sums), not a part to average."""
    res = [x[name] for x in ranks["four"]]
    assert res[0]["whole"]
    for x in res[1:]:
        if x["coords"]["data"] != res[0]["coords"]["data"]:
            continue
        for path, g in x["whole"].items():
            assert np.array_equal(g, res[0]["whole"][path]), (name, path)


def test_gqa_kv_heads_whole_where_they_do_not_divide(ranks):
    hd = smoke_config("qwen3-1.7b").resolved_head_dim
    # 2 kv heads on a 4-way axis: wk whole; on a 2-way one, a head a rank
    assert ranks["four"][0]["qwen3_1x4"]["local_wk"] == (256, 2 * hd)
    assert ranks["four"][0]["qwen3_2x2"]["local_wk"] == (256, hd)


def test_vocab_parallel_cross_entropy(ranks):
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(
        np.float32) * 4).requires_grad_()
    labels = torch.from_numpy(rng.integers(-1, 64, (2, 7)))
    loss = layers.cross_entropy(full, labels)
    (grad,) = torch.autograd.grad(loss, full)
    for r, x in enumerate(ranks["four"]):
        lr, gr = x["ce"]
        assert abs(lr - loss.item()) <= TOL * abs(loss.item())
        want = grad.numpy()[..., r * 16:(r + 1) * 16]
        assert _rel(gr, want) <= TOL, r


def test_split_cache_attention(ranks):
    for x in ranks["four"]:
        got, want = x["split_attention"]
        assert _rel(got, want) <= 1e-6


def test_cache_slots_not_dividing_stay_whole(ranks, single):
    for x in ranks["four"]:
        assert np.array_equal(x["whole_cache"], single["whole_cache"])


def test_checkpoint_restores_onto_smaller_model_axis(ranks):
    want = ranks["four"][0]["saved"]
    for res in ranks["two"]:
        assert len(res["state"]) == len(want["state"])
        for a, b in zip(res["state"], want["state"]):
            assert a.dtype == b.dtype and np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
        assert abs(res["loss"] - want["loss"]) <= TOL * abs(want["loss"])


def test_fp8_slice_off_128_raises(ranks):
    for x in ranks["four"]:
        assert x["fp8_raise"] and "multiple of 128" in x["fp8_raise"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "yi-9b", "pixtral-12b",
                                  "qwen2-moe-a2.7b", "deepseek-moe-16b",
                                  "minitron-8b", "qwen1.5-110b",
                                  "recurrentgemma-2b", "xlstm-350m",
                                  "whisper-tiny"])
def test_dense_storage_specs_follow_the_rules(arch):
    """The recurrent and audio families' leaves too: the RG-LRU's width,
    the mLSTM's heads and the sLSTM's channels split where the axis
    divides them; the leaves the rules keep whole stay whole."""
    cfg = smoke_config(arch)
    params = make_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    for sizes in ((2, 2), (1, 4), (1, 8)):
        m = tmesh.make_mesh(sizes, ("data", "model"), with_groups=False)
        n = m.shape["model"]
        specs = storage_specs(params, cfg, m)
        ref = sharding.build_param_specs(params, m)
        kv_whole = cfg.num_kv_heads % n or cfg.num_heads % n
        for path, spec in specs.items():
            if "/moe/" in path:
                continue
            leaf = path.rsplit("/", 1)[-1]
            whole = leaf in ("scale", "vision_proj", "conv", "lam", "w_a",
                             "w_i", "w_if", "w_og", "w_z") or (
                leaf in ("wk", "wv", "bk", "bv") and kv_whole) or (
                leaf in ("wq", "wo", "bq") and cfg.num_heads % n
                and "/slstm/" not in path) or (
                "/slstm/" in path and cfg.d_model % n) or (
                "/rglru/" in path and (cfg.lru_width or cfg.d_model) % n)
            if whole:
                assert all(a is None for a in spec), (arch, sizes, path)
            else:
                assert spec + (None,) * (len(ref[path]) - len(spec)) == \
                    ref[path], (arch, sizes, path)
                assert "model" in spec, (arch, sizes, path)
