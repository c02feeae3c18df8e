"""A run on the CPU at smoke size, the look for a chip skipped: sound, it
comes out correct; with the timed path broken underneath (a step that
returns its state unchanged, half the batch left out, a token altered
where it is produced) it comes out not correct."""
import contextlib
import time

import pytest
import torch

import smoke_cells as sc
from faults import FAULTS
from harness import cell, check, drivers
from harness.model import port_config, shape


def run_once(config, traffic, limits, seed=2 ** 31 + 5):
    torch.manual_seed(0)
    s = shape(config)
    ctx = drivers.Ctx(device=torch.device("cpu"), seed=seed, seconds=0.2,
                      trace=False, shape=s, port_cfg=port_config(config),
                      traffic=traffic, t_start=time.perf_counter())
    win = drivers.DRIVERS[traffic["kind"]](ctx)
    readings = cell.compare(s, traffic, win.work, win.outputs, seed,
                            ctx.device)
    return check.verdict(readings, limits)[0], readings


CASES = [("train", None), ("train", "state_unchanged"),
         ("train", "half_batch"), ("decode", None),
         ("decode", "token_altered"), ("prefill", None),
         ("prefill", "token_altered")]


@pytest.mark.parametrize("kind,fault", CASES,
                         ids=[f"{k}-{f or 'sound'}" for k, f in CASES])
def test_fault_makes_the_run_incorrect(kind, fault):
    config = sc.DS_SMOKE
    traffic = {"train": sc.TRAIN, "decode": sc.DECODE,
               "prefill": sc.PREFILL}[kind]
    limits = sc.LIMITS_TRAIN if kind == "train" else sc.LIMITS_SERVE
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        ok, readings = run_once(config, traffic, limits)
    assert ok == (fault is None), readings
