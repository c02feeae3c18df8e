"""FSDP (ZeRO-3 storage over ``data``, the reference's
``build_param_specs(..., fsdp=True)``) and the pod axis on gloo ranks of
this machine (CPU, plain kernel versions, f32), spawned through
``repro_torch.launch.ranks.run_ranks``: one 4-rank run holds every step
below, then 2 ranks restore its FSDP checkpoint.

- Storage: every leaf of every arch's smoke tree is stored by the FSDP
  rule on the port's model-axis layout, which equals
  ``build_param_specs(fsdp=True)`` wherever that layout is the rules'
  (the port keeps kv heads that do not divide the axis whole); the
  optimizer state's leaves take their params' specs (``tree_specs``).
- A train step (remat on: each cycle gathers its shards inside the
  checkpointed function) with ``fsdp=True`` equals the same step
  without it, within 1e-5 in loss, grad norm, every gathered gradient
  the optimizer is handed and every gathered updated param (of its
  largest element), on (2, 2) and (4, 1), for
  qwen3-1.7b (with and without ``compress_grads``, whose int8 scale is
  each logical tensor's max), recurrentgemma-2b, qwen2-moe-a2.7b (dense
  dispatch) and qwen3-1.7b with ``d_model`` 130: its norms' one dim does
  not divide a 4-way data axis, so the reference shards their stacked
  layer axis and the port keeps each layer's norm on the data rank that
  owns its block of layers (an ``Owner`` spec).  Every leaf FSDP could
  shard is (``sharding.FSDP_MIN_SIZE`` set to 1).
- Each rank's bytes of params and AdamW state equal the specs'
  arithmetic exactly; the leaves the reference shards on their stacked
  layer axis are listed for both production meshes and every arch (none
  at its 2^20-element threshold) and, for the 130-wide case, held at the
  reference spec's bytes on every rank.
- The pod axis: a step on (2, 2, 1) with FSDP and on (2, 1, 2) without
  (the batch's rows over the joint ``("pod", "data")`` axis) equals one
  process's step within 1e-5 in loss, grad norm and gradients, and
  within POD_PARAM_TOL in the updated params.

AdamW keeps its default ``eps`` (1e-8): its first update, lr * g /
(|g| + eps), is a sign-like function of each gradient element, so an
element within ~1e-8 of 0 that two reductions round apart moves its
param by up to 2 lr.  One process against the pod ranks sums the
batch's rows in another order and meets that (readings over init
seeds 1-5: gradients at most 7.1e-6 of a leaf's largest element, the
params 1.9e-4; FSDP against none on the same mesh: 1.3e-7 and 1.8e-7;
``python tests/test_torch_fsdp.py 1 2 3 4 5`` prints them).
- An FSDP checkpoint of the (2, 2) qwen3 step restores onto (1, 2)
  without FSDP bit for bit.
- recurrentgemma-2b's fp8 recipe in bf16 on (2, 2): FSDP with sequence
  parallelism gives TP alone's loss and gradients bit for bit.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.models.transformer import (param_shapes, param_specs,
                                            reference_stack, storage_specs)
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_leaves, tree_paths

TOL = 1e-5
POD_PARAM_TOL = 5e-4    # 2.6x the largest reading (module docstring)
SEQ, BATCH = 32, 4
SEED = 1            # the params' init
ARCHS = {
    "qwen3": ("qwen3-1.7b", {}),
    "qwen3odd": ("qwen3-1.7b", {"d_model": 130, "num_layers": 4}),
    "rg": ("recurrentgemma-2b", {}),
    "moe": ("qwen2-moe-a2.7b", {"precision": "bf16",
                                "moe_dispatch": "dense"}),
}
STEPS = {
    # name: (arch, mesh sizes, compress_grads)
    "qwen3_2x2": ("qwen3", (2, 2), False),
    "qwen3_2x2_int8": ("qwen3", (2, 2), True),
    "qwen3_4x1_int8": ("qwen3", (4, 1), True),
    "qwen3odd_4x1": ("qwen3odd", (4, 1), False),
    "rg_2x2": ("rg", (2, 2), False),
    "moe_2x2": ("moe", (2, 2), False),
}
PODS = {"pod_fsdp_2x2x1": ("qwen3", (2, 2, 1), True),
        "pod_2x1x2": ("rg", (2, 1, 2), False)}
#: leaves whose stacked layer axis the reference shards over data, on
#: the production meshes (16 x 16, and 2 x 16 x 16), by arch: none
PRODUCTION_STACKED = {}


def _cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(smoke_config(arch), dtype=torch.float32, **kw)


def _batch(cfg):
    return synthetic_batch(torch.Generator().manual_seed(0), cfg, SEQ, BATCH)


def _opt(compress):
    return adamw.OptConfig(use_master=False, compress_grads=compress,
                           warmup_steps=1)


@contextlib.contextmanager
def _grads_seen(specs=None, mesh=None):
    """Keep, gathered by ``specs``, the gradients each optimizer update
    is handed."""
    real, seen = adamw.apply_updates, []

    def apply(params, grads, *args, **kw):
        full = grads if specs is None else \
            sharding.gather_tree(grads, specs, mesh)
        seen.append({p: g.float().numpy().copy() for p, g in tree_paths(full)})
        return real(params, grads, *args, **kw)
    adamw.apply_updates = apply
    try:
        yield seen
    finally:
        adamw.apply_updates = real


def _step(cfg, mesh, fsdp, compress, seed=SEED):
    """One train step on ``mesh``: its metrics, the gathered gradients
    and updated params, this rank's state and its specs."""
    model = make_model(cfg, "cpu", mesh, fsdp=fsdp)
    params = model.init_params(torch.Generator().manual_seed(seed))
    opt_cfg = _opt(compress)
    opt = adamw.init_opt_state(params, opt_cfg)
    pspecs = storage_specs(params, cfg, mesh, fsdp=fsdp)
    step = make_train_step(model.loss, opt_cfg, mesh=mesh, specs=pspecs)
    with _grads_seen(pspecs, mesh) as grads:
        params, opt, metrics = step(params, opt, _batch(cfg))
    state = {"params": params, "opt": opt}
    specs = sharding.tree_specs(state, pspecs)
    full = sharding.gather_tree(params, pspecs, mesh)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "grads": grads[0],
            "params": {p: x.numpy() for p, x in tree_paths(full)}}, \
        state, specs


def _bytes(state, specs, mesh, cfg):
    """(this rank's bytes, the specs' arithmetic for this rank)."""
    shapes = param_shapes(cfg)
    have = want = 0
    for path, x in tree_paths(state):
        have += x.numel() * x.element_size()
        q = path.split("/", 2)
        leaf = path.split("/", 1)[1] if q[0] == "params" else \
            (q[2] if len(q) > 2 else None)
        shape = shapes.get(leaf, tuple(x.shape))
        want += sharding.local_numel(shape, specs[path], mesh) \
            * x.element_size()
    return have, want


def _owned(specs, mesh, cfg):
    """Bytes a rank holds of the leaves stored by an ``Owner`` spec, and
    what the reference's stacked spec gives a rank."""
    shapes, stack = param_shapes(cfg), reference_stack(cfg)
    here = ref = 0
    for path, spec in specs.items():
        if isinstance(spec, sharding.Owner):
            n = int(np.prod(shapes[path])) * 4
            here += n if mesh.coord("data") == spec.index else 0
            top = path.split("/")
            copies = stack[top[0]][int(top[1])][0]
            ref += n * copies // mesh.shape["data"] / copies
    return here, ref


def _rank(rank, world, ckpt_dir, seed=SEED):
    from repro_torch.checkpoint import checkpointer as ckpt
    sharding.FSDP_MIN_SIZE = 1      # every leaf the rule can shard
    meshes = {}

    def mesh_of(sizes):
        if sizes not in meshes:
            axes = ("data", "model") if len(sizes) == 2 else \
                ("pod", "data", "model")
            meshes[sizes] = tmesh.make_mesh(sizes, axes)
        return meshes[sizes]
    out = {}
    for name, (arch, sizes, compress) in STEPS.items():
        mesh, cfg = mesh_of(sizes), _cfg(arch)
        res = {}
        for fsdp in (False, True):
            res[fsdp], state, specs = _step(cfg, mesh, fsdp, compress, seed)
            res[fsdp]["bytes"] = _bytes(state, specs, mesh, cfg)
            res[fsdp]["owned"] = _owned(
                storage_specs(state["params"], cfg, mesh, fsdp=fsdp), mesh,
                cfg)
            res[fsdp]["sharded_over_data"] = sum(
                "data" in sharding.spec_axes(s) for s in specs.values())
            if name == "qwen3_2x2" and fsdp:
                ckpt.save(ckpt_dir, 0, state, mesh=mesh, specs=specs)
                full = sharding.gather_tree(state, specs, mesh)
                res["saved"] = [x.numpy() for x in tree_leaves(full)]
        out[name] = res
    for name, (arch, sizes, fsdp) in PODS.items():
        out[name] = _step(_cfg(arch), mesh_of(sizes), fsdp, False, seed)[0]
    out["fp8_bf16"] = _fp8_gradients(mesh_of((2, 2)))
    return out


def _fp8_cfg(seq_shard):
    """recurrentgemma-2b's smoke config widened so its 2-way slices stay
    on the fp8 kernels' 128 multiples, in bf16 with the fp8 recipe."""
    return dataclasses.replace(
        smoke_config("recurrentgemma-2b"), dtype=torch.bfloat16,
        precision="fp8", d_model=256, d_ff=512, lru_width=256,
        num_heads=2, head_dim=128, seq_shard=seq_shard)


def _fp8_gradients(mesh):
    """The loss and gathered gradients of the fp8 recipe in bf16 on
    ``mesh``: under TP alone, and under FSDP with sequence
    parallelism."""
    from repro_torch.train.trainer import make_grad_fn
    out = {}
    for fsdp in (False, True):
        cfg = _fp8_cfg(fsdp)
        model = make_model(cfg, "cpu", mesh, fsdp=fsdp)
        params = model.init_params(torch.Generator().manual_seed(1))
        specs = storage_specs(params, cfg, mesh, fsdp=fsdp)
        (loss, _), grads = make_grad_fn(model.loss, mesh=mesh, specs=specs)(
            params, synthetic_batch(torch.Generator().manual_seed(0), cfg,
                                    64, BATCH))
        full = sharding.gather_tree(grads, specs, mesh)
        out[fsdp] = (float(loss), {p: g.float().numpy()
                                   for p, g in tree_paths(full)},
                     {p: str(g.dtype).removeprefix("torch.")
                      for p, g in tree_paths(full)})
    return out


def _restore_rank(rank, world, ckpt_dir):
    from repro_torch.checkpoint import checkpointer as ckpt
    mesh = tmesh.make_mesh((1, world), ("data", "model"))
    cfg = _cfg("qwen3")
    model = make_model(cfg, "cpu", mesh)
    params = model.init_params(torch.Generator().manual_seed(9))
    opt = adamw.init_opt_state(params, _opt(False))
    state = {"params": params, "opt": opt}
    specs = sharding.tree_specs(state, storage_specs(params, cfg, mesh))
    _, _, s = ckpt.restore_latest(ckpt_dir, state, mesh=mesh, specs=specs)
    assert s == 0
    full = sharding.gather_tree(state, specs, mesh)
    return [x.numpy() for x in tree_leaves(full)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    ckpt_dir = str(d / "ckpt")
    four = run_ranks(_rank, 4, store_dir=str(d), timeout=300,
                     args=(ckpt_dir,))
    two = run_ranks(_restore_rank, 2, store_dir=str(d), timeout=120,
                    args=(ckpt_dir,))
    return {"four": four, "two": two}


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _close(got, want, param_tol=TOL):
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        TOL * abs(want["grad_norm"])
    for key, tol in (("grads", TOL), ("params", param_tol)):
        assert set(got[key]) == set(want[key])
        for path, x in got[key].items():
            assert _rel(x, want[key][path]) <= tol, (key, path)


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_step_matches_unsharded_storage(ranks, name):
    for res in (x[name] for x in ranks["four"]):
        assert res[True]["sharded_over_data"] > 0
        assert res[False]["sharded_over_data"] == 0
        _close(res[True], res[False])


@pytest.mark.parametrize("name", list(STEPS))
def test_rank_bytes_equal_the_spec_arithmetic(ranks, name):
    per_rank = []
    for res in (x[name] for x in ranks["four"]):
        for fsdp in (False, True):
            have, want = res[fsdp]["bytes"]
            assert have == want, (name, fsdp)
        per_rank.append(res[True]["bytes"][0])
        here, ref = res[True]["owned"]
        assert here == ref, (name, here, ref)
    # FSDP on a 2- or 4-way data axis: well under the unsharded bytes
    assert max(per_rank) < ranks["four"][0][name][False]["bytes"][0]


def test_owner_leaves_where_the_reference_shards_the_layer_axis(
        ranks, monkeypatch):
    """The 130-wide norms on a 4-way data axis: one layer a data rank."""
    monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", 1)
    cfg = _cfg("qwen3odd")
    m = tmesh.make_mesh((4, 1), ("data", "model"), with_groups=False)
    params = make_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    specs = storage_specs(params, cfg, m, fsdp=True)
    owned = {p: s.index for p, s in specs.items()
             if isinstance(s, sharding.Owner)}
    assert owned == {f"layers/{i}/{n}/scale": i for i in range(4)
                     for n in ("ln1", "ln2")}
    ref = sharding.build_param_specs(params, m, fsdp=True,
                                     stack=reference_stack(cfg))
    assert {p for p, s in ref.items()
            if isinstance(s, sharding.Owner)} == set(owned)
    for res in (x["qwen3odd_4x1"] for x in ranks["four"]):
        assert res[True]["owned"][0] == 2 * 130 * 4


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_stacked_axis_leaves(multi_pod):
    """Every arch's full-size tree (shapes on the meta device) on the
    production mesh: the leaves where the reference shards the stacked
    layer axis over data, with the bytes a data rank holds of each."""
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    found = {}
    for arch in TARCHS:
        cfg = get_config(arch)
        for path, spec in param_specs(cfg, mesh, fsdp=True).items():
            if isinstance(spec, sharding.Owner):
                found.setdefault(arch, {})[path] = \
                    int(np.prod(spec.shape)) * cfg.dtype.itemsize
    assert found == PRODUCTION_STACKED


@pytest.mark.parametrize("arch", list(TARCHS))
def test_fsdp_storage_follows_the_rules(arch, monkeypatch):
    """On (2, 2) and (4, 1): each leaf's FSDP spec is
    ``build_param_specs(fsdp=True)``'s wherever the port's model-axis
    layout is the rules' (every leaf on a model axis of 1); the optimizer
    state's leaves take their params' specs."""
    cfg = smoke_config(arch)
    params = make_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    stack = reference_stack(cfg)
    for sizes in ((2, 2), (4, 1)):
        m = tmesh.make_mesh(sizes, ("data", "model"), with_groups=False)
        mode = "ep" if cfg.moe is None or \
            cfg.moe.num_experts % m.shape["model"] == 0 else "tp"
        for least in (1, sharding.FSDP_MIN_SIZE):
            monkeypatch.setattr(sharding, "FSDP_MIN_SIZE", least)
            got = storage_specs(params, cfg, m, fsdp=True)
            want = sharding.build_param_specs(params, m, fsdp=True,
                                              stack=stack, moe_mode=mode)
            base = storage_specs(params, cfg, m)
            rules = sharding.build_param_specs(params, m, moe_mode=mode)
            # a model axis of 1 splits nothing: every leaf is the rules'
            same = [p for p in got if m.shape["model"] == 1
                    or base[p] + (None,) * (len(rules[p]) - len(base[p]))
                    == rules[p]]
            assert len(same) > len(got) // 2, (arch, sizes)
            for p in same:
                assert got[p] == want[p], (arch, sizes, p)
        state = {"params": params,
                 "opt": adamw.init_opt_state(params, _opt(True))}
        specs = sharding.tree_specs(state, got)
        for p, spec in got.items():
            for k in ("params", "opt/m", "opt/v", "opt/ef"):
                assert specs[f"{k}/{p}"] == spec
        assert specs["opt/step"] == ()


def _one_process(seed=SEED):
    """Each PODS case's step in one process (one intra-op thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (arch, _, _) in PODS.items():
            cfg = _cfg(arch)
            model = make_model(cfg, "cpu")
            params = model.init_params(torch.Generator().manual_seed(seed))
            opt = adamw.init_opt_state(params, _opt(False))
            step = make_train_step(model.loss, _opt(False))
            with _grads_seen() as grads:
                params, opt, metrics = step(params, opt, _batch(cfg))
            out[name] = {"loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "grads": grads[0],
                         "params": {p: x.numpy()
                                    for p, x in tree_paths(params)}}
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_process():
    return _one_process()


@pytest.mark.parametrize("name", list(PODS))
def test_pod_axis_step_matches_one_process(ranks, one_process, name):
    for res in (x[name] for x in ranks["four"]):
        _close(res, one_process[name], POD_PARAM_TOL)


def test_fsdp_and_seq_shard_add_no_rounding_to_fp8_tp(ranks):
    """The fp8 recipe in bf16 rounds sums of partials to bf16 and to e4m3
    tiles, so tensor parallelism moves it off one process's by that
    rounding (ROADMAP C); FSDP's gathers and sequence parallelism's
    gathers and reduce-scatters add none: the loss and every bf16
    gradient equal TP alone's bit for bit, and the f32 leaves' (the
    norms, which sequence parallelism sums over the ranks' chunks) sit
    within f32 reassociation (1e-6 of the largest element)."""
    for res in (x["fp8_bf16"] for x in ranks["four"]):
        (l0, g0, d0), (l1, g1, _) = res[False], res[True]
        assert l0 == l1
        assert set(g0) == set(g1)
        for path, g in g1.items():
            if d0[path] == "bfloat16":
                assert np.array_equal(g, g0[path]), path
            else:
                assert _rel(g, g0[path]) <= 1e-6, path


def test_fsdp_checkpoint_restores_onto_another_mesh(ranks):
    want = ranks["four"][0]["qwen3_2x2"]["saved"]
    for got in ranks["two"]:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(
                a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


if __name__ == "__main__":
    # the readings PARAM_TOL is set from: each case's largest gap in the
    # gathered gradients and the updated params (of each leaf's largest
    # element), FSDP against none and the pod steps against one process,
    # at the init seeds given (default 1-5)
    import os
    import sys
    import tempfile
    for seed in [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5]:
        with tempfile.TemporaryDirectory() as d:
            four = run_ranks(_rank, 4, store_dir=d, timeout=600,
                             args=(os.path.join(d, "ckpt"), seed))
        one = _one_process(seed)
        pairs = {name: [(x[name][True], x[name][False]) for x in four]
                 for name in STEPS}
        pairs.update({name: [(x[name], one[name]) for x in four]
                      for name in PODS})
        for name, rows in pairs.items():
            gap = {k: max(_rel(got[k][p], want[k][p])
                          for got, want in rows for p in want[k])
                   for k in ("grads", "params")}
            print(f"seed {seed} {name}: grads {gap['grads']:.3e} "
                  f"params {gap['params']:.3e}", flush=True)
