"""The work arithmetic against figures worked by hand for one layer of
each configuration."""
import dataclasses
import json

import pytest

from harness import manifest, work
from harness.model import shape


def _shape(name, **kw):
    c = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    return dataclasses.replace(shape(c), **kw)


DS = _shape("deepseek-moe-16b-l5", layers=2)      # the dense layer + 1 MoE
QW = _shape("qwen2-moe-a2.7b", layers=1)           # 1 MoE layer

ATTN = 2 * 2048 * (16 + 32) * 128 + 2 * 2048 * 2048      # 33,554,432


def test_deepseek_decode_step_one_token():
    f = work.model_flops_decode_step(DS, batch=1, cache_len=0)
    # routed 6 x 3 x 2 x 2048 x 1408, shared 3 x 2 x 2048 x 2816
    assert f["fp8"] == 103_809_024 + 34_603_008
    # two attention blocks, the dense MLP (3 x 2 x 2048 x 10944), the
    # router (2 x 2048 x 64), the head (2 x 2048 x 102400), one (q, k)
    # pair of attention a layer (4 x 16 x 128)
    assert f["bf16"] == 2 * ATTN + 134_479_872 + 262_144 + 419_430_400 \
        + 2 * 8192


def test_qwen_prefill_one_layer():
    f = work.model_flops_prefill(QW, batch=2, length=4)
    assert f["fp8"] == 2 * 4 * (69_206_016 + 69_206_016)
    # attention projections and router a token; the head once a prompt;
    # 10 causal pairs a prompt
    assert f["bf16"] == 8 * (ATTN + 245_760) + 2 * 622_329_856 \
        + 2 * 10 * 8192


def test_train_is_three_forwards_with_the_head_everywhere():
    one = work.model_flops_decode_step(QW, batch=1, cache_len=0)
    f = work.model_flops_train_step(QW, batch=1, seq=1)
    assert f == {k: 3 * v for k, v in one.items()}


def test_deepseek_routed_gate_gemm_at_16k_tokens():
    g = work.gmm_work(DS, 16384, backward=False)
    assert len(g) == 6          # one MoE layer: 3 routed + 3 shared
    gate = g[0]
    assert gate["flops"] == 2 * 98_304 * 2048 * 1408
    # e4m3 A + 1x128 f32 scales, 64 experts' e4m3 B + 128x128 scales,
    # bf16 out
    assert gate["bytes"] == pytest.approx(207_618_048 + 184_594_432
                                          + 276_824_064)
    assert work.least_seconds([gate]) == pytest.approx(
        2 * 98_304 * 2048 * 1408 / 1979e12)


def test_qwen_decode_counts_only_experts_with_rows():
    g = work.gmm_work(QW, 64, backward=False)[0]
    groups = 60 * (1 - (1 - 4 / 60) ** 64)
    assert 59.0 < groups < 60.0
    assert g["bytes"] == pytest.approx(
        256 * 2048 * (1 + 1 / 32) + groups * 2048 * 1408 * (1 + 4 / 16384)
        + 256 * 1408 * 2)
    # bound by bytes at 256 rows
    assert work.least_seconds([g]) == pytest.approx(g["bytes"] / 3.35e12)


def test_wgrad_and_dgrad_of_one_layer():
    dg = work.gmm_work(QW, 128, backward=True)
    assert len(dg) == 12
    # the routed gate's dgrad: dy [512, 1408] e4m3 @ w^T, f32 out
    assert dg[1]["flops"] == 2 * 512 * 1408 * 2048
    wg = work.wgrad_work(QW, 128)[0]
    groups = 60 * (1 - (1 - 4 / 60) ** 128)
    assert wg["bytes"] == pytest.approx(
        2 * 512 * 2048 + 2 * 512 * 1408 + 2 * groups * 2048 * 1408)
    assert wg["peak"] == "bf16"


def test_remat_runs_each_forward_gemm_again():
    plain = work.gmm_work(QW, 128, backward=True)
    remat = work.gmm_work(QW, 128, backward=True, remat=True)
    assert len(remat) == 18     # 6 forward twice + 6 dgrads
    assert sum(g["flops"] for g in remat) == pytest.approx(
        sum(g["flops"] for g in plain)
        + sum(g["flops"] for g in work.gmm_work(QW, 128, backward=False)))


def test_the_reference_routing_sets_the_experts_with_rows():
    seen = work.gmm_work(QW, 64, backward=False, active={64: [7]})[0]
    assumed = work.gmm_work(QW, 64, backward=False)[0]
    weights = 2048 * 1408 * (1 + 4 / 16384)
    assert seen["bytes"] == pytest.approx(
        assumed["bytes"] - (60 * (1 - (1 - 4 / 60) ** 64) - 7) * weights)
    # a size the reference did not route takes the expectation
    other = work.gmm_work(QW, 32, backward=False, active={64: [7]})[0]
    assert other == work.gmm_work(QW, 32, backward=False)[0]


def test_a_training_window_counts_each_microbatch():
    wk = {"kind": "train", "batch": 4, "seq": 64, "grad_accum": 2,
          "remat": True, "steps": 3}
    one = work.gmm_work(QW, 128, backward=True, remat=True)
    assert work.window_gmm(QW, wk) == one * 6
    assert work.window_wgrad(QW, wk, {128: [5]}) == \
        work.wgrad_work(QW, 128, {128: [5]}) * 6
