"""The port's checkpointer: the JAX package's four checkpoint cases
(``tests/test_checkpoint_optim.py``) on trees of bf16, f32 and int32
tensors, every leaf bitwise; and the file format shared with the JAX
package: the port restores a checkpoint the JAX checkpointer wrote, bit
for bit, and its own save of the same values writes the same
``arrays.npz`` entries (names, dtype strings, bytes)."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.float32),
                       "w": torch.randn(4, 6, generator=g).bfloat16(),
                       "step": torch.tensor(seed, dtype=torch.int32)}}


def _bits(x: torch.Tensor) -> bytes:
    return x.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def _assert_bitwise(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    path = ckpt.save(d, 5, tree)
    assert ckpt.latest_step(d) == 5
    like = tree_map(torch.zeros_like, tree)
    restored, meta = ckpt.restore(d, 5, like)
    assert restored is like
    _assert_bitwise(restored, tree)
    assert meta["step"] == 5 and meta["num_leaves"] == 4
    assert meta["dtypes"] == ["float32", "float32", "int32", "bfloat16"]
    assert sorted(os.listdir(path)) == ["arrays.npz", "meta.json"]


def test_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, _tree(s), keep_last=2)
    steps = sorted(ckpt.all_steps(d))
    assert steps == [4, 5]
    assert ckpt.latest_step(d) == 5
    restored, _, s = ckpt.restore_latest(d, tree_map(torch.zeros_like,
                                                     _tree()))
    assert s == 5
    _assert_bitwise(restored, _tree(5))


def test_torn_latest_falls_back_to_scan(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, _tree())
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("99")               # pointer to a nonexistent step
    assert ckpt.latest_step(d) == 3


def test_orphan_tmp_dir_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    os.makedirs(os.path.join(d, ".tmp_step_2"))   # simulated crash
    assert ckpt.latest_step(d) == 1
    restored, _, s = ckpt.restore_latest(d, _tree(7))
    assert s == 1
    _assert_bitwise(restored, _tree())
    assert ckpt.restore_latest(str(tmp_path / "empty"), _tree()) == \
        (None, None, None)


def test_restore_rejects_another_structure(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(d, 0, {"a": torch.zeros(8, 16)})
    wrong = _tree()
    wrong["a"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 0, wrong)


def _values():
    """bf16, int32 and 0-d f32 leaves, as numpy (bf16 as f32 values)."""
    rng = np.random.default_rng(0)
    return {"b": rng.standard_normal((3, 5)).astype(np.float32),
            "i": np.arange(-3, 4, dtype=np.int32),
            "s": np.float32(3.25)}


def test_restores_a_jax_checkpoint_and_writes_its_entries(tmp_path):
    v = _values()
    jtree = {"b": jnp.asarray(v["b"], jnp.bfloat16),
             "i": jnp.asarray(v["i"]), "s": jnp.asarray(v["s"])}
    jpath = jckpt.save(str(tmp_path / "jax"), 4, jtree)
    ttree = {"b": torch.from_numpy(v["b"]).bfloat16(),
             "i": torch.from_numpy(v["i"]),
             "s": torch.tensor(v["s"])}

    like = tree_map(torch.zeros_like, ttree)
    restored, meta, s = ckpt.restore_latest(str(tmp_path / "jax"), like)
    assert s == 4 and meta["num_leaves"] == 3
    _assert_bitwise(restored, ttree)

    path = ckpt.save(str(tmp_path / "port"), 4, ttree)
    with np.load(os.path.join(jpath, "arrays.npz")) as want, \
            np.load(os.path.join(path, "arrays.npz")) as got:
        assert sorted(got.files) == sorted(want.files) == ["a0", "a1", "a2"]
        for name in want.files:
            assert got[name].dtype.str == want[name].dtype.str, name
            assert got[name].shape == want[name].shape, name
            assert got[name].tobytes() == want[name].tobytes(), name
        assert want["a0"].dtype.str == "|V2"
    with open(os.path.join(jpath, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(path, "meta.json")) as f:
        tmeta = json.load(f)
    assert set(jmeta) < set(tmeta)
    assert {k: tmeta[k] for k in ("step", "num_leaves")} == \
        {k: jmeta[k] for k in ("step", "num_leaves")}
    assert tmeta["dtypes"] == ["bfloat16", "int32", "float32"]
    # and back: the JAX checkpointer reads the port's int32 and f32 leaves
    # (its own restore cannot cast |V2 bytes back to bfloat16)
    jback, _ = jckpt.restore(str(tmp_path / "port"), 4,
                             {"b": np.zeros((3, 5), np.float32),
                              "i": jnp.zeros(7, jnp.int32),
                              "s": jnp.zeros((), jnp.float32)})
    np.testing.assert_array_equal(np.asarray(jback["i"]), v["i"])
    assert np.asarray(jback["s"]).tobytes() == v["s"].tobytes()


@pytest.mark.parametrize("compress", [False, True])
def test_optimizer_state_resumes_bitwise(tmp_path, compress):
    """The trainer's state (bf16 params; AdamW's f32 m, v and masters,
    with ``compress_grads`` the int8 error-feedback residuals; the 0-d
    int32 step) saved after two updates and restored into a fresh state:
    the next update from it is bitwise the live one's."""
    cfg = adamw.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          compress_grads=compress)
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(16, 32, generator=g).bfloat16(),
              "b": [torch.randn(32, generator=g).bfloat16()]}
    state = adamw.init_opt_state(params, cfg)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=g)
                      .bfloat16(), params) for _ in range(3)]
    for gr in grads[:2]:
        params, state, _ = adamw.apply_updates(params, gr, state, cfg)
    live = {"params": params, "opt": state}
    assert ("ef" in state) == compress
    ckpt.save(str(tmp_path), 1, live)
    fresh = adamw.init_opt_state(tree_map(torch.zeros_like, params), cfg)
    restored, _, s = ckpt.restore_latest(
        str(tmp_path), {"params": tree_map(torch.zeros_like, params),
                        "opt": fresh})
    assert s == 1
    _assert_bitwise(restored, live)
    a = adamw.apply_updates(params, grads[2], state, cfg)
    b = adamw.apply_updates(restored["params"], grads[2], restored["opt"],
                            cfg)
    _assert_bitwise(a[:2], b[:2])
