"""Architecture registry of the port.

``get_config(name)`` returns the full ModelConfig; ``smoke_config(name)``
a reduced same-family config for CPU tests.  Only the architectures whose
paths are ported are here; the others raise "not yet ported".
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoESpec  # noqa: F401

#: every architecture of the JAX package
ARCHS = (
    "yi-9b", "minitron-8b", "qwen3-1.7b", "qwen1.5-110b", "whisper-tiny",
    "xlstm-350m", "qwen2-moe-a2.7b", "deepseek-moe-16b", "pixtral-12b",
    "recurrentgemma-2b",
)
#: those the port runs
PORTED = ("qwen2-moe-a2.7b", "qwen3-1.7b", "deepseek-moe-16b")


def _mod(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: {PORTED}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()
