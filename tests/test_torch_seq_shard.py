"""Sequence parallelism (``ModelConfig.seq_shard``, the reference's
Megatron-SP) on gloo ranks of this machine (CPU, plain kernel versions,
f32), spawned through ``repro_torch.launch.ranks.run_ranks``: one 4-rank
run holds every case, under a model axis of 4 ((1, 4)) and of 2 beside
data parallelism 2 ((2, 2)).

On each mesh, the same model with ``seq_shard`` on is held against it
with ``seq_shard`` off (the tensor parallelism that
``tests/test_torch_tp.py`` and ``tests/test_torch_tp_recurrent.py`` hold
against one process), within 1e-5 of the largest element: the logits of
a training forward, the loss and every gathered gradient; then a greedy
generate (its prefill sequence-parallel, its decode steps of S = 1
whole): the same tokens, and each step's logits within 1e-5.  The cases:
qwen3-1.7b (dense, GQA), qwen2-moe-a2.7b (the MoE gathered, its partials
reduce-scattered; dense dispatch in f32, as in the TP file),
recurrentgemma-2b (on (1, 4) its attention runs whole on every rank
between the split RG-LRU blocks) and xlstm-350m (on (1, 4) its 2 mLSTM
heads run whole, its sLSTM split), and whisper-tiny on (2, 2).  A
sequence of 30 does not divide a 4-way axis and stays whole: the same
logits, bit for bit, as with ``seq_shard`` off.

The port's ``spec_for`` with the dry run's ``{"seq": "model"}`` rules is
held bit for bit against the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.distributed import context as jctx
from repro_torch.configs import smoke_config
from repro_torch.distributed import context as tctx
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.models.transformer import seq_parallel, storage_specs
from repro_torch.serve.engine import Engine
from repro_torch.tree import tree_paths

TOL = 1e-5
SEQ, BATCH, NEW = 32, 2, 4
ARCHS = {
    "qwen3": ("qwen3-1.7b", {}),
    "qwen2moe": ("qwen2-moe-a2.7b", {"precision": "bf16",
                                     "moe_dispatch": "dense"}),
    "rg": ("recurrentgemma-2b", {}),
    "xlstm": ("xlstm-350m", {}),
    "whisper": ("whisper-tiny", {}),
}
CASES = {f"{a}_{m[0]}x{m[1]}": (a, m) for a in ARCHS
         for m in ((1, 4), (2, 2)) if a != "whisper" or m == (2, 2)}


def _cfg(name, seq_shard):
    arch, kw = ARCHS[name]
    return dataclasses.replace(smoke_config(arch), dtype=torch.float32,
                               seq_shard=seq_shard, **kw)


def _run(cfg, mesh, seq=SEQ):
    from repro_torch.distributed import context as dctx
    from repro_torch.models.transformer import tp_split
    from repro_torch.train.trainer import make_grad_fn
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(1))
    batch = synthetic_batch(torch.Generator().manual_seed(0), cfg, seq,
                            BATCH)
    group = mesh.group("model")
    vocab = tp_split(cfg, mesh.shape["model"])["vocab"]
    with torch.no_grad():
        if cfg.family == "audio":
            from repro_torch.models.whisper import whisper_forward
            logits = whisper_forward(params, batch["tokens"],
                                     batch["frames"], cfg, mesh=mesh)[0]
        else:
            from repro_torch.models.transformer import decoder_forward
            logits = decoder_forward(params, batch["tokens"], cfg,
                                     mesh=mesh)[0]
    if vocab:
        logits = dctx.all_gather(logits, -1, group)
    (loss, _), grads = make_grad_fn(model.loss, mesh=mesh)(params, batch)
    full = sharding.gather_tree(grads, storage_specs(params, cfg, mesh),
                                mesh)
    engine = Engine(model, params, max_new_tokens=NEW, device="cpu")
    tokens = engine.generate(batch).tokens
    with torch.inference_mode():
        last, cache = engine.prefill(batch, seq + NEW)
        steps = [last]
        for i in range(NEW - 1):
            lg, cache = engine.decode_step(tokens[:, i], cache)
            steps.append(lg)
    return {"logits": logits.numpy(), "loss": float(loss),
            "grads": {p: g.numpy() for p, g in tree_paths(full)},
            "tokens": tokens.numpy(), "steps": torch.stack(steps).numpy(),
            "sp": seq_parallel(cfg, mesh, seq)}


def _rank(rank, world):
    meshes = {s: tmesh.make_mesh(s, ("data", "model"))
              for s in ((1, 4), (2, 2))}
    out = {}
    for name, (arch, sizes) in CASES.items():
        out[name] = {on: _run(_cfg(arch, on), meshes[sizes])
                     for on in (False, True)}
    out["whole"] = {on: _run(_cfg("qwen3", on), meshes[(1, 4)], seq=30)
                    for on in (False, True)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank, 4, store_dir=str(tmp_path_factory.mktemp("sp")),
                     timeout=300)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_shard_matches_tensor_parallel(ranks, name):
    for r, res in enumerate(x[name] for x in ranks):
        on, off = res[True], res[False]
        assert on["sp"] and not off["sp"]
        assert _rel(on["logits"], off["logits"]) <= TOL, (name, r)
        assert abs(on["loss"] - off["loss"]) <= TOL * abs(off["loss"])
        assert set(on["grads"]) == set(off["grads"])
        for path, g in on["grads"].items():
            assert _rel(g, off["grads"][path]) <= TOL, (name, r, path)


@pytest.mark.parametrize("name", list(CASES))
def test_seq_shard_serves_the_same_tokens(ranks, name):
    for r, res in enumerate(x[name] for x in ranks):
        on, off = res[True], res[False]
        assert np.array_equal(on["tokens"], off["tokens"]), (name, r)
        assert _rel(on["steps"], off["steps"]) <= TOL, (name, r)


def test_sequence_not_dividing_the_axis_stays_whole(ranks):
    for res in (x["whole"] for x in ranks):
        on, off = res[True], res[False]
        assert not on["sp"]
        assert np.array_equal(on["logits"], off["logits"])
        assert np.array_equal(on["tokens"], off["tokens"])


SPEC_CASES = [
    ((8, 128, 256), ("batch", "seq", "embed")),
    ((8, 128, 256), ("batch", None, "embed")),
    ((8, 128, 16, 64), ("batch", "seq", "heads", None)),
    ((8, 130, 256), ("batch", "seq", "embed")),
    ((8, 256, 1408), ("batch", "seq", "mlp")),
    ((1024, 102400), ("seq", "vocab")),
    ((16, 16), ("seq", "heads")),
    ((8, 1), ("batch", "seq")),
]


@pytest.mark.parametrize("sizes", [(2, 4), (1, 8), (2, 2, 2)])
def test_spec_for_with_seq_rules_matches_reference(sizes):
    """The dry run's ``set_mesh(mesh, rules={"seq": "model"})``, taken as
    an argument, bit for bit (the reference reads only the mesh's
    ``shape`` and ``axis_names``, which the port's shape-only mesh
    has)."""
    axes = ("data", "model") if len(sizes) == 2 else \
        ("pod", "data", "model")
    m = tmesh.make_mesh(sizes, axes, with_groups=False)
    rules = {"seq": "model"}
    try:
        jctx.set_mesh(m, rules=rules)
        for shape, logical in SPEC_CASES:
            assert tctx.spec_for(shape, logical, m, rules) == \
                tuple(jctx.spec_for(shape, logical)), (shape, logical)
        jctx.set_mesh(m)
        for shape, logical in SPEC_CASES:
            assert tctx.spec_for(shape, logical, m) == \
                tuple(jctx.spec_for(shape, logical)), (shape, logical)
    finally:
        jctx.set_mesh(None)
