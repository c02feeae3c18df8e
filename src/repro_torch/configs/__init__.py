"""Architecture registry of the port: every architecture of the JAX
package.

``get_config(name)`` returns the full ModelConfig; ``smoke_config(name)``
a reduced same-family config for CPU tests; ``run_hints(name)`` the
launcher hints (microbatch sizes; xlstm's mLSTM chunk).  The presets keep
the JAX package's fields, with one difference: ``qwen2-moe-a2.7b`` and
``deepseek-moe-16b`` default to ``precision="fp8"``; every other preset
keeps the reference's bf16.  ``SHAPES`` (the dry run's input shapes),
``ShapeConfig``, ``FULL_ATTENTION_ARCHS`` and ``cell_is_runnable`` are
the JAX package's.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    FULL_ATTENTION_ARCHS, SHAPES, ModelConfig, MoESpec, ShapeConfig,
    cell_is_runnable)

#: every architecture of the JAX package
ARCHS = (
    "yi-9b", "minitron-8b", "qwen3-1.7b", "qwen1.5-110b", "whisper-tiny",
    "xlstm-350m", "qwen2-moe-a2.7b", "deepseek-moe-16b", "pixtral-12b",
    "recurrentgemma-2b",
)
#: those the port runs: all of them
PORTED = ARCHS


def _mod(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()


def run_hints(name: str) -> dict:
    """Per-arch launcher hints (microbatching and the like)."""
    return getattr(_mod(name), "RUN_HINTS", {})
