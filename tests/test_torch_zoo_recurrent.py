"""The port's whole models of the recurrent and encoder-decoder
architectures added to the zoo (recurrentgemma-2b, xlstm-350m,
whisper-tiny) against the JAX package's, with the helpers and at the
tolerances of ``tests/test_torch_zoo_models.py`` (its docstring gives
each with its reason): prefill and decode logits along the port's greedy
tokens (recurrentgemma-2b's prompt longer than its smoke window, so the
decode steps run on the ring-buffer cache), one batch's loss and every
weight's gradient, whisper's encoder alone, whisper-tiny in fp8 (its
MLPs on the kernels' plain versions, the fused activation quantizer in
its gelu mode; JAX on its Pallas kernels in interpret mode), the window
gate, and the entry points on the CPU.
"""
import functools

import numpy as np
import jax
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import whisper as jwhisper
from repro_torch.configs import smoke_config
from repro_torch.kernels import epilogue_kernel
from repro_torch.models import whisper as twhisper
from repro_torch.models.model_zoo import make_model
from test_torch_zoo_models import (BATCH, NEW, PROMPT, TOL, TOL_FP8,
                                   _inputs, _pair, _prefill_and_decode,
                                   check_entry_points, check_loss_and_grads,
                                   rel_to_max)
# the autouse one-thread fixture, for this file too
from test_torch_zoo_models import _one_torch_thread  # noqa: F401

RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-350m", "whisper-tiny")


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_prefill_decode_and_greedy_tokens_match_jax(name):
    rg = name == "recurrentgemma-2b"
    pair = _pair(name)
    cache = _prefill_and_decode(*pair, 48 if rg else PROMPT, TOL)
    cfg = pair[2].cfg
    if rg:
        # the attention layer's cache is the ring of `window` slots
        attn = [c for c in cache["layers"] if "k" in c]
        assert attn and all(c["k"].shape[1] == cfg.window for c in attn)
    if name == "whisper-tiny":
        # the decode steps read the cross K/V and the encoder output,
        # which prefill built apart from the self-attention cache
        lc = cache["layers"][0]
        assert lc["xkv"][0].data_ptr() != lc["self"]["k"].data_ptr()
        assert cache["enc_out"].shape == (BATCH, cfg.encoder_seq,
                                          cfg.d_model)


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_loss_and_grads_match_jax(name):
    check_loss_and_grads(name)


def test_whisper_encoder_matches_jax():
    _, jparams, model, params = _pair("whisper-tiny")
    jb, tb = _inputs(model.cfg, 8)
    want = jax.jit(functools.partial(jwhisper.whisper_encode,
                                     cfg=jax_smoke_config("whisper-tiny")))(
        jparams, jb["frames"])
    with torch.inference_mode():
        got = twhisper.whisper_encode(params, tb["frames"], model.cfg)
    assert got.shape == tb["frames"].shape and got.dtype == torch.bfloat16
    assert rel_to_max(got, want) <= TOL


def test_whisper_fp8_matches_jax(monkeypatch):
    """whisper-tiny in fp8 (d 128, d_ff 256: every MLP on the fp8 path,
    the down projection's input through the fused activation quantizer
    in its gelu mode), against the JAX package on its Pallas kernels in
    interpret mode."""
    jmodel, jparams, model, params = _pair(
        "whisper-tiny",
        {"precision": "fp8", "gemm_backend": "pallas_interpret"},
        {"precision": "fp8"})
    acts = []
    real = epilogue_kernel.act_quantize

    def spy(g, u=None, **kw):
        acts.append(kw["act"])
        return real(g, u, **kw)
    monkeypatch.setattr(epilogue_kernel, "act_quantize", spy)
    _prefill_and_decode(jmodel, jparams, model, params, PROMPT, TOL_FP8)
    cfg = model.cfg
    # a generate, then the prefill and decode steps again: each prefill
    # runs every encoder and decoder MLP, each decode step the decoder's
    assert acts == ["gelu"] * 2 * (cfg.encoder_layers + cfg.num_layers * NEW)


def test_window_gate():
    """recurrentgemma-2b at smoke size (window 32): decoding position t + 1
    after a prefill of t > window gives the logits of a prefill of t + 1
    (the reference's consistency test, ``tests/test_models_smoke.py``,
    bounds it by 0.15 absolute; held here at 2e-2 of the largest
    logit)."""
    cfg = smoke_config("recurrentgemma-2b")
    model = make_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, 71)))
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": toks}, cache_capacity=71)
        _, cache = model.prefill(params, {"tokens": toks[:, :70]},
                                 cache_capacity=71)
        step, _ = model.decode_step(params, toks[:, 70:], cache)
    a, b = full[:, -1].float(), step[:, 0].float()
    assert float((a - b).abs().max() / a.abs().max()) <= TOL
    assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("name", RECURRENT_ARCHS)
def test_entry_points_on_cpu(name, capsys):
    check_entry_points(name, capsys)
