"""Activation rematerialization (``ModelConfig.remat``) of the port, on the
CPU through the plain kernel versions, at smoke sizes.

1. Gradients (and the loss) of one step with ``remat=True`` are bitwise
   those with ``remat=False``: the recomputed forward repeats the first
   one exactly.  qwen3-1.7b (f32), qwen2-moe-a2.7b in fp8 (the
   quantizers and grouped GEMMs' plain versions; also through the
   trainer with the fp8 wgrad, whose kernel-config scope the trainer
   leaves before the backward), deepseek-moe-16b (a dense ``pre``
   layer), recurrentgemma-2b cut to 5 layers (a cycle of 3, then a tail
   of 2) and whisper-tiny (every encoder and decoder layer).
2. What is recomputed: each layer of a cycle of ``block_pattern`` runs
   twice in a step, the ``pre`` and ``tail`` layers once, as the JAX
   package leaves them outside its checkpointed scan; whisper's layers
   twice; nothing twice without gradients or outside training.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whs
from repro_torch.models.model_zoo import make_model, synthetic_batch
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

CASES = {
    "qwen3-1.7b": dict(dtype=torch.float32),
    "qwen2-moe-a2.7b": dict(precision="fp8"),
    "deepseek-moe-16b": dict(dtype=torch.float32, precision="fp8"),
    "recurrentgemma-2b": dict(dtype=torch.float32, num_layers=5),
    "whisper-tiny": dict(dtype=torch.float32),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(smoke_config(arch), **CASES[arch], **kw)


def _step(arch, remat):
    cfg = _cfg(arch, remat=remat)
    model = make_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, 32, 2)
    (loss, _), grads = value_and_grad(model.loss, params, batch)
    return loss, tree_leaves(grads)


@pytest.mark.parametrize("arch", list(CASES))
def test_remat_gradients_bitwise(arch):
    loss0, g0 = _step(arch, False)
    loss1, g1 = _step(arch, True)
    assert torch.equal(loss0, loss1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remat_trainer_fp8_wgrad_bitwise():
    """Two trainer steps with the fp8 wgrad: ``make_train_step`` scopes
    that kernel config around the loss only, and the recomputation in the
    backward runs under the forward's scope, so both runs are one."""
    out = []
    for remat in (False, True):
        cfg = _cfg("qwen2-moe-a2.7b", remat=remat)
        model = make_model(cfg, "cpu")
        gen = torch.Generator().manual_seed(0)
        params = model.init_params(gen)
        batch = synthetic_batch(gen, cfg, 32, 2)
        opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=4, warmup_steps=1)
        opt = adamw.init_opt_state(params, opt_cfg)
        step = make_train_step(model.loss, opt_cfg, wgrad_precision="fp8")
        hist = []
        for _ in range(2):
            params, opt, m = step(params, opt, batch)
            hist.append((m["loss"], m["grad_norm"]))
        out.append((hist, tree_leaves(params)))
    for (a, b), (c, d) in zip(out[0][0], out[1][0]):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch, pre, cycle, tail", [
    ("deepseek-moe-16b", 1, 2, 0), ("recurrentgemma-2b", 0, 3, 2),
    ("qwen3-1.7b", 0, 2, 0)])
def test_remat_recomputes_cycles_not_pre_or_tail(monkeypatch, arch, pre,
                                                 cycle, tail):
    cfg = _cfg(arch)
    assert cfg.remat
    model = make_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, 32, 2)
    layers = params["layers"]
    assert len(layers) == pre + cycle + tail
    calls = _count_calls(monkeypatch, tfm, "block_apply")
    value_and_grad(model.loss, params, batch)
    runs = [sum(c[1] is lp for c in calls) for lp in layers]
    assert runs == [1] * pre + [2] * cycle + [1] * tail
    calls.clear()
    with torch.no_grad():
        model.loss(params, batch)
    model.prefill(params, batch)
    assert len(calls) == 2 * len(layers)


def test_whisper_remat_recomputes_every_layer(monkeypatch):
    cfg = _cfg("whisper-tiny")
    model = make_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(gen)
    batch = synthetic_batch(gen, cfg, 32, 2)
    calls = _count_calls(monkeypatch, whs, "_mlp")
    value_and_grad(model.loss, params, batch)
    assert len(calls) == 2 * (cfg.encoder_layers + cfg.num_layers)
    calls.clear()
    value_and_grad(make_model(dataclasses.replace(cfg, remat=False),
                              "cpu").loss, params, batch)
    assert len(calls) == cfg.encoder_layers + cfg.num_layers
    calls.clear()
    model.prefill(tree_map(lambda x: x.detach(), params), batch)
    assert len(calls) == cfg.encoder_layers + cfg.num_layers
