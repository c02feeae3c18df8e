"""The dry run's ``prefill_32k`` cell on one rank of the 16 x 16
production mesh, one cycle of each config (``check_cell`` of
``test_torch_dryrun_cells.py``), for the dense and VLM archs; the
others' in ``test_torch_dryrun_prefill_other.py``."""
import pytest
import torch

from test_torch_dryrun_cells import check_cell

ARCHS = ("yi-9b", "minitron-8b", "qwen3-1.7b", "qwen1.5-110b",
         "pixtral-12b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cell_traces_on_the_production_mesh(arch):
    check_cell(arch, "prefill_32k")
