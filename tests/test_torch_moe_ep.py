"""The port's expert-parallel and TP MoE partials against the JAX
package's, in one process: for each rank r of n, the port's
``moe_apply(ep_rank=r, ep_size=n)`` on its slice of the params against
the reference's ``moe_apply(..., ep_rank=r, ep_size=n, axis_name=None)``
on the slice the reference's ``shard_moe_params`` spec gives (Pallas
kernels in interpret mode, jitted once a case with the rank traced, as
``shard_map``'s ``axis_index`` is).

Grades: the slices and the routing bitwise; every quantizer output
(the packed xs and the shared x) and every tile plan (group sizes,
offsets, visit schedule) bitwise; the packed GEMM output's rows past
``sum(group_sizes)`` exactly zero; the partial within 2e-2 of its
largest value, the bound of ``tests/test_torch_moe.py`` (the fused
epilogue's e4m3 steps and the GEMMs' bf16 rounding); the load-balance
loss within 1e-5 and the drop fraction within 1e-6 (XLA divides by the
slot count as a multiply by its reciprocal).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import moe as jmoe
from repro.kernels.plan import KernelConfig as JConfig
from repro.kernels.plan import make_tile_plan as jmake_tile_plan
from repro_torch.convert import tree_from_numpy
from repro_torch.core import moe as tmoe
from repro_torch.kernels.plan import KernelConfig
from repro_torch.launch.mesh import Mesh

D, F = 256, 256


def _slice_np(a, spec, r, n):
    """Rank r's slice of ``a`` under the reference's spec (one axis)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            c = a.shape[dim] // n
            a = np.take(a, np.arange(r * c, (r + 1) * c), axis=dim)
    return a


def _spy(module, name, store):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        store.append((args, out))
        return out
    return real, spy


def _reference(jcfg, params_np, x, ep, n, ranks):
    """The reference's partial, aux, quantizer outputs and the routed
    experts' plan (built from the group sizes its first grouped GEMM
    takes: its bf16 recipe plans inside each GEMM) for each rank, one jit
    with the rank traced."""
    pspec = jmoe.shard_moe_params(params_np, jcfg, ep)
    quants, gemms = [], []
    real_q, spy_q = _spy(jmoe, "quantize_activation", quants)
    real_g, spy_g = _spy(jmoe, "grouped_linear", gemms)

    def fn(p, xx, rank):
        quants.clear()
        gemms.clear()
        y, aux = jmoe.moe_apply(p, xx, jcfg, ep_rank=rank if ep > 1 else 0,
                                ep_size=ep, axis_name=None)
        xs, w, gs = gemms[0][0][:3]
        pl = jmake_tile_plan(gs, xs.shape[0], block_m=block_m,
                             num_groups=w.shape[0])
        return (y, aux, [(q.q, q.scale) for _, q in quants],
                (gs, pl.group_offsets, pl.group_ids, pl.m_tile_ids))
    block_m = jcfg.kernel_config.block_m
    jmoe.quantize_activation, jmoe.grouped_linear = spy_q, spy_g
    try:
        run = jax.jit(fn)
        out = []
        for r in ranks:
            local = {k: jnp.asarray(_slice_np(v, pspec[k], r, n))
                     for k, v in params_np.items()}
            out.append(jax.tree.map(np.asarray, run(local, x, r)))
    finally:
        jmoe.quantize_activation, jmoe.grouped_linear = real_q, real_g
    return pspec, out


def _port(tcfg, tparams, tx, ep, n, r, monkeypatch):
    quants, plans, packed = [], [], []
    for mod, name, store in ((tmoe, "quantize_activation", quants),
                             (tmoe, "make_tile_plan", plans),
                             (tmoe, "grouped_linear_fused", packed),
                             (tmoe, "grouped_linear", packed)):
        monkeypatch.setattr(mod, name, _spy(mod, name, store)[1])
    local = tmoe.slice_moe_params(tparams, tcfg,
                                  Mesh(("model",), (n,), rank=r))
    with torch.inference_mode():
        y, aux = tmoe.moe_apply(local, tx, tcfg, ep_rank=r if ep > 1 else 0,
                                ep_size=ep)
    monkeypatch.undo()
    return local, y, aux, quants, plans, packed[-1][1]


def _params(e, rng, shared=2):
    """The JAX package's ``init_moe_params`` shapes, scales and dtypes
    (bf16 experts, an f32 router), drawn with numpy."""
    fs = F * shared
    shapes = {"router": ((D, e), D), "w_gate": ((e, D, F), D),
              "w_up": ((e, D, F), D), "w_down": ((e, F, D), F),
              "shared_gate": ((D, fs), D), "shared_up": ((D, fs), D),
              "shared_down": ((fs, D), fs)}
    return {k: (rng.standard_normal(shape) * fan_in ** -0.5).astype(
        np.float32 if k == "router" else jnp.bfloat16)
        for k, (shape, fan_in) in shapes.items()}


CASES = {
    # name: (precision, block_m, experts, n, capacity_factor, tokens)
    # rank 0 gets no slot, and the others drop rows past their capacity
    "ep_fp8_m16_drop_idle": ("fp8", 16, 8, 4, 0.5, 40),
    "ep_bf16_m128_pad": ("bf16", 128, 8, 2, 8.0, 32),    # cap > slots
    "tp_fp8_m128": ("fp8", 128, 5, 2, 2.0, 32),
    "tp_bf16_m16": ("bf16", 16, 5, 2, 2.0, 24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_partials_match_reference(case, monkeypatch):
    prec, block_m, e, n, cf, tokens = CASES[case]
    dims = dict(num_experts=e, top_k=2, d_model=D, d_ff_expert=F,
                num_shared_experts=2, capacity_factor=cf, precision=prec)
    jcfg = jmoe.MoEConfig(**dims, backend="pallas_interpret",
                          kernel_config=JConfig(block_m=block_m))
    tcfg = tmoe.MoEConfig(**dims, kernel_config=KernelConfig(block_m=block_m))
    ep = jmoe.ep_size_for(jcfg, n)
    assert ep == tmoe.ep_size_for(tcfg, n) == (n if case[:2] == "ep" else 1)
    rng = np.random.default_rng(tokens)
    params = _params(e, rng)
    x = rng.standard_normal((tokens, D)).astype(np.float32)
    if "idle" in case:                # no token picks rank 0's experts
        x[:, 0] = 50.0
        params["router"][0, :e // n] = -1.0
    xb = x.astype(jnp.bfloat16)
    jx = jnp.asarray(xb)
    tx = torch.from_numpy(xb.astype(np.float32)).bfloat16()
    tparams = tree_from_numpy(params)
    pspec, refs = _reference(jcfg, params, jx, ep, n, range(n))
    # the reference leaves trailing dims out of a spec; the port's rules
    # name every dim
    specs = tmoe.shard_moe_params(None, tcfg, ep)
    assert set(specs) == set(pspec)
    for k, v in pspec.items():
        assert tuple(v) + (None,) * (len(specs[k]) - len(v)) == specs[k], k
    kept = 0
    for r, (want, jaux, jquants, jplan) in enumerate(refs):
        local, got, aux, quants, plans, packed = _port(
            tcfg, tparams, tx, ep, n, r, monkeypatch)
        for k, v in local.items():
            np.testing.assert_array_equal(
                v.float().numpy(), _slice_np(params[k], pspec[k], r, n)
                .astype(np.float32))
        # quantizer outputs and schedules, bitwise
        assert len(quants) == len(jquants)
        for (_, q), (jq, js) in zip(quants, jquants):
            np.testing.assert_array_equal(q.q.view(torch.uint8).numpy(),
                                          jq.view(np.uint8))
            np.testing.assert_array_equal(q.scale.numpy(), js)
        (gs, _), pl = plans[0]          # the routed experts' plan
        for a, b in zip((gs, pl.group_offsets, pl.group_ids, pl.m_tile_ids),
                        jplan):
            np.testing.assert_array_equal(a.numpy(), b)
        total = int(plans[0][0][0].sum())
        kept += total
        assert packed.shape[0] == plans[0][1].m
        assert not packed[total:].any(), "rows past sum(group_sizes)"
        if "idle" in case and r == 0:
            assert total == 0
        # the partial
        want = want.astype(np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, (r, err)
        np.testing.assert_allclose(float(aux["load_balance_loss"]),
                                   float(jaux["load_balance_loss"]),
                                   rtol=1e-5)
        assert abs(float(aux["dropped_fraction"])
                   - float(jaux["dropped_fraction"])) <= 1e-6
    slots = tokens * 2
    if ep > 1:
        assert (kept < slots) == ("drop" in case), (kept, slots)
        if "pad" in case:
            assert tmoe._capacity(slots, n, cf, align=block_m) > slots
    else:
        assert kept == n * slots


def test_group_of_one_is_no_group():
    """A process group of one rank gives exactly the single-rank call."""
    import torch.distributed as dist
    cfg = tmoe.MoEConfig(num_experts=4, top_k=2, d_model=D, d_ff_expert=F,
                         num_shared_experts=1)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(cfg, generator=gen, device="cpu",
                             dtype=torch.bfloat16)
    x = torch.randn(16, D, generator=gen).bfloat16()
    want, _ = tmoe.moe_apply(p, x, cfg)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got, _ = tmoe.moe_apply(p, x, cfg, group=dist.new_group([0]))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


def test_bad_expert_ranks_raise():
    cfg = tmoe.MoEConfig(num_experts=6, top_k=2, d_model=D, d_ff_expert=F)
    x = torch.zeros(4, D)
    for kw in (dict(ep_size=4), dict(ep_rank=2, ep_size=2),
               dict(ep_size=0)):
        with pytest.raises(ValueError, match="expert rank"):
            tmoe.moe_apply({}, x, cfg, **kw)


def test_tp_slice_needs_the_kernels_alignment():
    """qwen2-moe-a2.7b's d_ff 1408 over a model axis of 8 (its 60 experts
    do not divide 8: TP) leaves 176 columns a rank, no multiple of the
    GEMM kernels' 128-wide tiles: the fp8 and the bf16 recipes raise with
    the kernels' reason, as the reference's Pallas fp8 path does."""
    for prec in ("fp8", "bf16"):
        cfg = tmoe.MoEConfig(num_experts=60, top_k=4, d_model=D,
                             d_ff_expert=1408, precision=prec)
        assert tmoe.ep_size_for(cfg, 8) == 1
        full = {k: torch.zeros(shape, dtype=torch.bfloat16) for k, shape in
                (("router", (D, 60)), ("w_gate", (60, D, 1408)),
                 ("w_up", (60, D, 1408)), ("w_down", (60, 1408, D)))}
        local = tmoe.slice_moe_params(full, cfg, Mesh(("model",), (8,),
                                                      rank=0))
        assert local["w_gate"].shape == (60, D, 176)
        with pytest.raises(ValueError, match="multiple of block_n=128"):
            tmoe.moe_apply(local, torch.zeros(16, D).bfloat16(), cfg)
