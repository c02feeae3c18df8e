"""The port's dry run (``repro_torch.launch.dryrun.lower_cell``) on one
rank of the 16 x 16 production mesh, each config cut to one cycle of its
block pattern (``dryrun.cut_to_cycles``; the widths untouched): every
arch's runnable train, decode and long-context cells here, the prefill
cells in ``test_torch_dryrun_prefill_dense.py`` and
``test_torch_dryrun_prefill_other.py``.  Every cell traces (``ok``), or
raises for a known guard only: qwen2-moe-a2.7b's 60 experts do not
divide the 16-way model axis, so its experts split ``d_ff`` 1408 into 88
columns a rank, below the 128-column tiles of the fp8 kernels (B2) and
of the bf16 one (B5) alike (ROADMAP C, "TP needs 128-column slices");
its dense (GShard) dispatch, plain batched products, traces.  Every fp8
MoE cell ran the shape-only B1, B2 and B3 (and B4 in training).

xlstm-350m's train cell is traced here at 256 tokens, not 4096, as is
its prefill: its sLSTM block is an eager scan of one step a token, and
one cycle's train_4k took 167 s to trace (prefill_32k 285 s) on fake
tensors on an 8-core CPU; ``python -m repro_torch.launch.dryrun --all`` traces
both at their shapes (PERF.md).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, \
    cell_is_runnable, get_config
from repro_torch.launch import dryrun

#: arch -> the error its ragged MoE raises on 16 x 16 in fp8 (B2) and in
#: bf16 (B5): 88 columns a rank (the guards), and the dispatch that
#: traces there
GUARDS = {"qwen2-moe-a2.7b": ("N=88 must be a multiple of block_n=128",
                              {"moe_dispatch": "dense"})}
#: cells traced at a shorter sequence here (module docstring)
SHORT = {("xlstm-350m", "train_4k"), ("xlstm-350m", "prefill_32k")}
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if s != "prefill_32k" and cell_is_runnable(a, s)]


def check_cell(arch: str, shape, *, guard: bool = True) -> dict:
    """Trace ``arch``'s cell of ``shape`` (a name or a ShapeConfig) at
    rank 17 of 16 x 16, one cycle deep; where a guard applies, the
    preset raises its reason (with ``guard``) and the bf16 recipe is
    traced instead.  Returns the record after its checks."""
    cfg = dryrun.cut_to_cycles(get_config(arch))
    if arch in GUARDS:
        reason, cfg_fix = GUARDS[arch]
        for precision in (None, "bf16") if guard else ():
            with pytest.raises(ValueError, match=reason):
                dryrun.lower_cell(arch, shape, multi_pod=False, config=cfg,
                                  precision=precision, rank=17)
        cfg = dataclasses.replace(cfg, **cfg_fix)
    rec = dryrun.lower_cell(arch, shape, multi_pod=False, config=cfg,
                            rank=17)
    assert rec["ok"] and rec["chips"] == 256 and rec["mesh"] == "16x16"
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["fits_card"]
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    kind = (shape if isinstance(shape, ShapeConfig) else SHAPES[shape]).kind
    kernels = set(rec["cost"]["kernels"])
    if cfg.moe is None or cfg.moe_dispatch == "dense":
        assert not kernels          # plain products (ROADMAP C)
    elif rec["precision"] == "fp8":
        assert {"gmm", "quantize_tilewise", "act_quantize"} <= kernels
        assert ("gmm_wgrad" in kernels) == (kind == "train")
    else:
        assert "gmm_bf16" in kernels
    if kind == "decode":
        assert rec["cache_bytes"] > 0
        assert rec["cache_bytes_reference_layout"] > 0
    return rec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_traces_on_the_production_mesh(arch, shape):
    if (arch, shape) in SHORT:
        shape = dataclasses.replace(SHAPES[shape], name=f"{shape}@256",
                                    seq_len=256)
    check_cell(arch, shape)


def test_xlstm_prefill_traces_at_a_short_prompt():
    check_cell("xlstm-350m", dataclasses.replace(
        SHAPES["prefill_32k"], name="prefill_32k@256", seq_len=256))
