"""The port's meshes and partition rules against the JAX package's, as
pure logic (no process group, no devices).

The reference builds meshes with ``jax.make_mesh``, which this process
(one CPU device) cannot; it is handed a stand-in that records the shape
it asks for, and its ``spec_for`` / ``build_param_specs`` read only a
mesh's ``shape`` and ``axis_names``, which the port's shape-only
``Mesh`` has.  Param shapes come from ``jax.eval_shape`` of each arch's
smoke init.  The reference stacks layers (``layers/b<i>/...`` with a
leading cycle axis, ``pre<i>``/``tail<i>`` unstacked; whisper's stacked
``enc_layers`` and ``layers``); its specs are mapped onto the port's
per-layer paths and the leading ``None`` of a stacked leaf dropped.
Whisper's ``enc_layers`` is not a ``layers`` path component, so the
reference does not see it as stacked (ROADMAP C); the test hands it that
subtree under ``enc/layers``, where it does.
"""
import dataclasses
import functools

import jax
import pytest
import torch

import repro.launch.mesh as jmesh
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.distributed import context as jctx
from repro.distributed import sharding as jsharding
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed import context as tctx
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model_zoo import make_model
from repro_torch.models.transformer import reference_stack, storage_specs

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


@pytest.fixture
def fake_make_mesh(monkeypatch):
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))


@pytest.mark.parametrize("model_parallel", [None, 1, 2, 4])
def test_make_mesh_for_matches_reference(fake_make_mesh, model_parallel):
    for n in range(1, 17):
        if model_parallel is not None and n % model_parallel:
            continue
        want = jmesh.make_mesh_for(n, model_parallel=model_parallel)
        got = tmesh.make_mesh_for(n, model_parallel=model_parallel)
        assert (got.sizes, got.axis_names) == want, n
        assert got.groups is None and got.size == n


def test_production_mesh_matches_reference(fake_make_mesh):
    for multi_pod in (False, True):
        want = jmesh.make_production_mesh(multi_pod=multi_pod)
        got = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (got.sizes, got.axis_names) == want


SPEC_CASES = [
    ((8, 128, 256), ("batch", "seq", "embed")),
    ((8, 128, 16, 64), ("batch", "seq", "heads", None)),
    ((8, 128, 4, 64), ("batch", "kv_seq", "heads", None)),
    ((8, 256, 1408), ("batch", "seq", "mlp")),
    ((6, 256, 176), ("expert", None, "mlp")),
    ((1024, 102400), ("seq", "vocab")),
    ((3, 1000), ("batch", "vocab")),
    ((16, 16), ("seq", "heads")),
]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_matches_reference(mesh):
    """The reference reads its mesh from process-wide state; the port
    takes it as an argument."""
    m = tmesh.make_mesh(*MESHES[mesh], with_groups=False)
    try:
        jctx.set_mesh(m)
        for shape, axes in SPEC_CASES:
            assert tctx.spec_for(shape, axes, m) == \
                tuple(jctx.spec_for(shape, axes)), (shape, axes)
        assert tctx.model_axis_size(m) == jctx.model_axis_size() == \
            m.shape["model"]
        jctx.set_mesh(None)
        assert tctx.spec_for((4, 4), ("batch", None), None) == \
            tuple(jctx.spec_for((4, 4), ("batch", None))) == ()
        assert tctx.model_axis_size(None) == jctx.model_axis_size() == 1
    finally:
        jctx.set_mesh(None)


def _path_str(path) -> str:
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                    for p in path)


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    return jax.eval_shape(jzoo.make_model(jsmoke(arch)).init_params,
                          jax.random.PRNGKey(0))


def _reference_specs(cfg, mesh, **kw):
    """The reference's specs on its own (stacked) smoke tree, keyed by the
    port's per-layer paths."""
    shapes = dict(_reference_shapes(cfg.name))
    if cfg.family == "audio":
        enc = shapes.pop("enc_layers")
        shapes = {**shapes, "enc": {"layers": enc}}
    specs = jsharding.build_param_specs(shapes, mesh, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    pattern = tuple(cfg.block_pattern) or ("attn",)
    n_pre = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    cycles = (cfg.num_layers - n_pre) // len(pattern)
    out = {}
    for path, spec in flat:
        parts, spec = _path_str(path).split("/"), tuple(spec)
        if parts[0] == "enc":                      # whisper's encoder
            for i in range(cfg.encoder_layers):
                out["/".join(["enc_layers", str(i), *parts[2:]])] = spec[1:]
        elif parts[0] == "layers" and cfg.family == "audio":
            for i in range(cfg.num_layers):
                out["/".join(["layers", str(i), *parts[1:]])] = spec[1:]
        elif parts[0] == "layers":                 # stacked cycles
            j = int(parts[1][1:])
            for c in range(cycles):
                i = n_pre + c * len(pattern) + j
                out["/".join(["layers", str(i), *parts[2:]])] = spec[1:]
        elif parts[0].startswith(("pre", "tail")):
            i = int(parts[0][3:]) if parts[0].startswith("pre") else \
                n_pre + cycles * len(pattern) + int(parts[0][4:])
            out["/".join(["layers", str(i), *parts[1:]])] = spec
        else:
            out["/".join(parts)] = spec
    return out


@pytest.fixture(scope="module")
def port_trees():
    trees = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        trees[arch] = (cfg, make_model(cfg, "cpu").init_params(
            torch.Generator().manual_seed(0)))
    return trees


@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_param_specs_match_reference(mesh, port_trees):
    assert set(JARCHS) == set(ARCHS)
    m = tmesh.make_mesh(*MESHES[mesh], with_groups=False)
    for arch, (cfg, params) in port_trees.items():
        stack = reference_stack(cfg)
        for kw in (dict(moe_mode="ep"), dict(moe_mode="tp"),
                   dict(moe_mode="ep", fsdp=True),
                   dict(moe_mode="ep", fsdp=True, fsdp_min_size=1 << 12),
                   dict(moe_mode="tp", fsdp=True, fsdp_min_size=1)):
            want = _reference_specs(cfg, m, **kw)
            got = tsharding.build_param_specs(params, m, stack=stack, **kw)
            assert got == want, (arch, mesh, kw, {
                p: (got.get(p), want.get(p)) for p in set(got) | set(want)
                if got.get(p) != want.get(p)})


def test_storage_specs_shard_only_the_moe_leaves(port_trees):
    """The port stores the MoE leaves sharded (EP on 8 experts / 4, the
    shared experts' d_ff) and, since tensor parallelism, every dense leaf
    of attention, the MLP, the embedding and the head too, each as the
    partition rules lay it out (its heads, d_ff and vocab divide the
    4-way axis here); norms, the router and the qk-norm scales whole; an
    optimizer state's leaves take their params' specs.  The name is
    kept from when only the MoE leaves were sharded."""
    cfg, params = port_trees["deepseek-moe-16b"]
    m = tmesh.make_mesh((2, 4), ("data", "model"), with_groups=False)
    specs = storage_specs(params, cfg, m)
    ref = tsharding.build_param_specs(params, m)
    moe = {f"layers/{i}/moe/{k}" for i, layer in enumerate(params["layers"])
           for k in layer.get("moe", ())}
    assert moe and set(specs) == set(ref)
    assert specs["layers/1/moe/w_gate"][0] == "model"
    for path, spec in specs.items():
        if path in moe or not path.endswith(("scale", "router")):
            assert spec + (None,) * (len(ref[path]) - len(spec)) == \
                ref[path], path
        else:
            assert all(a is None for a in spec), path
    assert specs["embed/embedding"] == ("model", None)
    assert specs["layers/0/attn/wq"] == (None, "model")
    state = {"params": params, "opt": {"m": params, "step": torch.zeros(())}}
    state_specs = tsharding.tree_specs(state, specs)
    assert state_specs["opt/step"] == ()
    for path, spec in specs.items():
        assert state_specs[f"params/{path}"] == spec == \
            state_specs[f"opt/m/{path}"]
    placed = dataclasses.replace(m, rank=6)      # data 1, model 2
    local = tsharding.shard_tree(params, specs, placed)
    w = params["layers"][1]["moe"]["w_gate"]
    assert torch.equal(local["layers"][1]["moe"]["w_gate"], w[4:6])
    sg = params["layers"][1]["moe"]["shared_gate"]
    n = sg.shape[1] // 4
    assert torch.equal(local["layers"][1]["moe"]["shared_gate"],
                       sg[:, 2 * n:3 * n])
    emb = params["embed"]["embedding"]
    n = emb.shape[0] // 4
    assert torch.equal(local["embed"]["embedding"], emb[2 * n:3 * n])
    assert local["final_norm"]["scale"] is params["final_norm"]["scale"]
    # a dim over ("model", "data"): 8 chunks, model major: chunk 2 * 2 + 1
    x = torch.arange(32).reshape(16, 2)
    assert torch.equal(tsharding.slice_leaf(x, (("model", "data"), None),
                                            placed), x[10:12])
