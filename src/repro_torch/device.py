"""Device selection and the environment probe.

Entry points run on CUDA unless the caller asks for the CPU; without a
card they raise rather than fall back.  :func:`probe` records what a
measurement has to be reported with: the card's name and power limit,
the torch, CUDA and Triton versions and the ``nvcc`` in use.
"""
from __future__ import annotations

import importlib.metadata
import shutil
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def gpu_name_and_power_limit() -> "str | None":
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, as
    printed, or None where ``nvidia-smi`` is missing."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=False)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def probe() -> dict:
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = None
    try:
        from repro_torch.kernels.build import nvcc_path
        nvcc = nvcc_path()
    except RuntimeError:
        nvcc = None
    cuda = torch.cuda.is_available()
    return {
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": gpu_name_and_power_limit(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "triton": triton,
        "nvcc": nvcc,
    }
