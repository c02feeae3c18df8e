"""The dry run's ``prefill_32k`` cell on one rank of the 16 x 16
production mesh, one cycle of each config (``check_cell`` of
``test_torch_dryrun_cells.py``), for whisper-tiny, the MoE archs and
recurrentgemma-2b; xlstm-350m's is traced at a short prompt in
``test_torch_dryrun_cells.py``.  qwen2-moe-a2.7b's guard (its ragged MoE's 88
columns a rank) is held on its train and decode cells there; here its
dense dispatch is traced."""
import pytest
import torch

from test_torch_dryrun_cells import check_cell

ARCHS = ("whisper-tiny", "qwen2-moe-a2.7b", "deepseek-moe-16b",
         "recurrentgemma-2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_traces_on_the_production_mesh(arch):
    check_cell(arch, "prefill_32k", guard=False)
