"""The port's TilePlan schedule against the JAX package's, bit for bit."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import plan as jplan
from repro_torch.analysis import events
from repro_torch.kernels import plan as tplan

# jitted: the reference builds its schedule inside jitted layers
_jax_metadata = jax.jit(jplan.make_group_metadata, static_argnums=(1, 2, 3))

SIZES = {
    "ragged": [5, 0, 17, 200, 0, 3, 64, 1],
    "empty_groups": [0, 0, 40, 0, 0, 129, 0],
    "all_empty": [0, 0, 0, 0],
    "single": [300],
    "ones": [1, 1, 1, 1, 1, 1],
}


@pytest.mark.parametrize("block_m", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_group_metadata_bitwise(block_m, case):
    sizes = SIZES[case]
    for tail in (0, 37):             # tail > 0: sum(sizes) < M
        m = sum(sizes) + tail
        ref = _jax_metadata(jnp.array(sizes, jnp.int32), m, block_m,
                            len(sizes))
        got = tplan.make_group_metadata(
            torch.tensor(sizes, dtype=torch.int32), m, block_m, len(sizes))
        for r, g in zip(ref, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_random_ragged_sizes_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(8):
        g = int(rng.integers(1, 70))
        sizes = rng.integers(0, 40, g) * (rng.random(g) < 0.7)
        m = int(sizes.sum() + rng.integers(0, 50))
        bm = int(rng.choice([8, 16, 64, 128, 256]))
        ref = _jax_metadata(jnp.asarray(sizes, jnp.int32), m, bm, g)
        got = tplan.make_group_metadata(
            torch.tensor(sizes, dtype=torch.int32), m, bm, g)
        for r, t in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), t.numpy())


def test_tile_plan_fields_and_event():
    gs = torch.tensor([3, 0, 9], dtype=torch.int32)
    with events.capture() as evs:
        p = tplan.make_tile_plan(gs, 16, block_m=8)
    assert events.count(evs, "plan_build") == 1
    assert (p.m, p.block_m, p.num_groups) == (16, 8, 3)
    assert p.num_tiles == 2 and p.max_visits == 4
    assert int(p.total_rows()) == 12
    p.check_against(16, 8, 3)
    with pytest.raises(ValueError, match="TilePlan built for"):
        p.check_against(16, 16, 3)


def test_kernel_config_checks():
    assert tplan.KernelConfig() == tplan.KernelConfig(128, 128, 128)
    for kw in (dict(block_m=12), dict(block_n=64), dict(block_k=96)):
        with pytest.raises(ValueError):
            tplan.KernelConfig(**kw)
    cfg = tplan.KernelConfig(block_m=16)
    assert cfg.validate(5, 256, 384) is cfg
    with pytest.raises(ValueError, match="K=200"):
        cfg.validate(5, 200, 384)
    with pytest.raises(ValueError, match="N=100"):
        cfg.validate(5, 256, 100)
    assert tplan.resolve_config(None, out_dtype=torch.float32) == \
        tplan.KernelConfig(out_dtype=torch.float32)
