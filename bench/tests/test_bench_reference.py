"""The plain reference against the port on the CPU at the smoke sizes,
through the port's plain kernels: the forward's logits, the loss and
every leaf's gradient, and the AdamW update."""
import pytest
import torch

import smoke_cells as sc
from harness.model import leaf_paths, make_params, port_config, shape
from reference import model as ref

SEED = 2 ** 31 + 17


def _port(config):
    from repro_torch.models.model_zoo import make_model
    return make_model(port_config(config), "cpu")


def _tokens(vocab, b=2, s=128):
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, vocab, (b, s), generator=g)


@pytest.mark.parametrize("config", [sc.DS_SMOKE, sc.QWEN_SMOKE],
                         ids=["deepseek", "qwen2moe"])
def test_forward_logits(config):
    """Each position's largest logit error, over the largest logit: the
    median position within 8% (e4m3 steps of 1/16 flip where bf16
    activations move a value across a step; a routing flip moves a whole
    token), and under a quarter of the int4 control's."""
    from repro_torch.models import transformer as tfm
    s = shape(config)
    model = _port(config)
    params = make_params(s, SEED, "cpu")
    x = _tokens(s.vocab)
    rp = ref.f32_params(params)
    with torch.no_grad():
        got = tfm.decoder_forward(params, x, model.cfg,
                                  mode="train")[0].float()
        err = {}
        for grid in ("e4m3", "int4"):
            h, _ = ref.hidden(rp, x, s, grid)
            want = h @ rp["embed"]["lm_head"]
            err[grid] = float(((got - want).abs().amax(-1)
                               / want.abs().amax()).median())
    assert err["e4m3"] < 0.08
    assert err["e4m3"] < err["int4"] / 4


@pytest.mark.parametrize("config", [sc.DS_SMOKE, sc.QWEN_SMOKE],
                         ids=["deepseek", "qwen2moe"])
def test_loss_and_gradients(config):
    from repro_torch.train.trainer import value_and_grad
    s = shape(config)
    model = _port(config)
    params = make_params(s, SEED, "cpu")
    x = _tokens(s.vocab)
    (loss, _), grads = value_and_grad(model.loss, params,
                                      {"tokens": x, "labels": x})
    rp = ref.f32_params(params)
    paths = leaf_paths(rp)
    leaves = [p.requires_grad_(True) for _, p in paths]
    rloss = ref.lm_loss(rp, x, s, "e4m3")
    rgrads = torch.autograd.grad(rloss, leaves)
    rl = float(rloss.detach())
    assert abs(float(loss) - rl) < 1e-2 * rl
    norms = [float(g.norm()) for g in rgrads]
    med = sorted(norms)[len(norms) // 2]
    for (path, g), rg in zip(leaf_paths(grads), rgrads):
        gap = abs(float(g.float().norm()) - float(rg.norm()))
        assert gap < 0.05 * max(float(rg.norm()), med), path


def test_adamw_matches_the_port():
    from repro_torch.optim import adamw
    opt = dict(sc.OPT)
    cfg = adamw.OptConfig(**opt, use_master=False)
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(64, 32, generator=g),
              "b": torch.randn(7, generator=g)}
    mine = [params["a"].clone(), params["b"].clone()]
    state = adamw.init_opt_state(params, cfg)
    rstate = {"m": [torch.zeros_like(p) for p in mine],
              "v": [torch.zeros_like(p) for p in mine]}
    for step in range(1, 4):
        grads = {"a": torch.randn(64, 32, generator=g) * 3,
                 "b": torch.randn(7, generator=g) * 3}
        adamw.apply_updates(params, grads, state, cfg)
        ref.adamw_step(mine, [grads["a"], grads["b"]], rstate, step, opt)
    torch.testing.assert_close(mine[0], params["a"], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(mine[1], params["b"], rtol=1e-6, atol=1e-7)


def test_int4_is_coarser_than_e4m3():
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    e8 = (ref.quant_rows(x, "e4m3") - x).abs().mean()
    i4 = (ref.quant_rows(x, "int4") - x).abs().mean()
    assert i4 > 4 * e8
    w = torch.randn(256, 384, generator=torch.Generator().manual_seed(2))
    assert (ref.quant_blocks(w, "int4") - w).abs().mean() > \
        4 * (ref.quant_blocks(w, "e4m3") - w).abs().mean()


def test_layer_at_a_time_logits_and_routing():
    """The serving check's forward, one layer's weights at a time, gives
    the whole tree's logits; its routing counts the experts with rows of
    each prompt and of each decode position."""
    from harness import check
    s = shape(sc.QWEN_SMOKE)
    x = _tokens(s.vocab, b=2, s=24)
    pos = torch.arange(15, 24)
    routes = [{}]
    got = check._ref_logits([(x, None, pos)], s, SEED, "cpu", "e4m3",
                            routes)[0]
    rp = make_params(s, SEED, "cpu", f32=True)
    h, _ = ref.hidden(rp, x, s, "e4m3")
    torch.testing.assert_close(got, h[:, pos] @ rp["embed"]["lm_head"])
    counts = check._serve_experts([(x, None, pos)], routes, new=9)
    assert set(counts) == {2 * 16, 2}
    for i, ids in routes[0].items():
        layer = sorted(routes[0]).index(i)
        assert counts[32][layer] == len(set(ids[:, :16].flatten().tolist()))
        assert counts[2][layer] == pytest.approx(sum(
            len(set(ids[:, 16 + j].flatten().tolist()))
            for j in range(8)) / 8)
