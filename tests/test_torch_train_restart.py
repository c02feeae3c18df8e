"""Fault tolerance of the port's trainer (``tests/test_train_restart.py``
of the JAX package, in-process): crash mid-training, restart, and the
resumed run reproduces the uninterrupted one bit for bit (stateless data,
atomic checkpoints of params and AdamW state, the schedule a function of
the arguments alone).

Cases: the smoke qwen3-1.7b in f32 through the command line, as the
reference's test runs it, and the smoke deepseek-moe-16b in fp8 (bf16
params with f32 masters, so bf16 leaves go through the checkpoint too)
under the paper's padded baseline."""
import dataclasses

import pytest
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import smoke_config
from repro_torch.launch import train as tlaunch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's ops while this file runs: the
    smoke shapes gain nothing from more, and beside the other test
    workers PyTorch's thread pool oversubscribes the cores.  Restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STEPS, SAVE_EVERY, FAIL_AT = 30, 10, 17


def _qwen3(ckpt_dir, fail_at, capsys):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--steps", str(STEPS), "--batch", "4", "--seq", "64",
            "--dtype", "f32", "--save-every", str(SAVE_EVERY),
            "--log-every", "1", "--ckpt-dir", ckpt_dir,
            "--fail-at-step", str(fail_at)]
    try:
        run = tlaunch.main(argv)
    finally:
        out = capsys.readouterr().out     # a crashed run's lines go too
    return run.history, out


def _deepseek_padded(ckpt_dir, fail_at, capsys):
    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"),
                              gemm_backend="padded_baseline")
    assert cfg.precision == "fp8"
    lines = []
    run = tlaunch.train(cfg, steps=STEPS, batch=4, seq=64, device="cpu",
                        ckpt_dir=ckpt_dir, save_every=SAVE_EVERY,
                        fail_at_step=fail_at, log=lines.append)
    return run.history, "\n".join(lines)


@pytest.mark.parametrize("case", [_qwen3, _deepseek_padded],
                         ids=["qwen3-f32", "deepseek-fp8-padded"])
def test_crash_restart_reproduces_uninterrupted_run(case, tmp_path, capsys):
    ref, _ = case(str(tmp_path / "ref"), -1, capsys)
    assert [h["step"] for h in ref] == list(range(STEPS))
    assert sorted(ckpt.all_steps(str(tmp_path / "ref"))) == [9, 19, 29]

    d = str(tmp_path / "crash")
    with pytest.raises(SystemExit, match=f"injected failure.*{FAIL_AT}"):
        case(d, FAIL_AT, capsys)
    assert ckpt.latest_step(d) == SAVE_EVERY - 1
    resumed, out = case(d, -1, capsys)
    assert f"[resume] restored step {SAVE_EVERY - 1} from {d}" in out
    assert [h["step"] for h in resumed] == list(range(SAVE_EVERY, STEPS))
    for a, b in zip(resumed, ref[SAVE_EVERY:], strict=True):
        assert (a["loss"], a["grad_norm"], a["lr"]) == \
            (b["loss"], b["grad_norm"], b["lr"]), a["step"]
    assert ref[-1]["loss"] < ref[0]["loss"]
