"""The ports of the JAX package's two remaining examples, on the CPU
(``--device cpu``; both default to the card): ``examples/
quickstart_torch.py`` trains the reduced qwen3-1.7b in f32 and then
generates, its loss falling as the reference asserts;
``examples/serve_decode_torch.py`` prefills a batch of prompts and
decodes with temperature sampling from a seeded generator (the reduced
recurrentgemma-2b: recurrent state and a windowed KV cache), returning
batch x max-new tokens, the same tokens for the same seeds."""
import importlib.util
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_loss_falls_then_generates(capsys):
    first, last, res = _example("quickstart_torch").main(
        ["--device", "cpu", "--steps", "12"])
    assert last < first
    assert tuple(res.tokens.shape) == (2, 12)
    out = capsys.readouterr().out
    assert "qwen3-1.7b (reduced)" in out and "(improved)" in out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen3-1.7b"])
def test_serve_decode_returns_batch_by_max_new(arch, capsys):
    example = _example("serve_decode_torch")
    argv = ["--device", "cpu", "--arch", arch, "--batch", "3",
            "--prompt-len", "32", "--max-new", "5"]
    res = example.main(argv)
    assert tuple(res.tokens.shape) == (3, 5)
    assert int(res.num_generated.sum()) == 15
    again = example.main(argv)
    assert torch.equal(res.tokens, again.tokens)      # seeded sampling
    kind = "recurrent" if arch == "recurrentgemma-2b" else "KV-cache"
    assert f"15 tokens generated ({arch}, {kind} decode)" in \
        capsys.readouterr().out
