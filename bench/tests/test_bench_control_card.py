"""On the card, at the cell's own size: the control (the reference at
the int4 grid in the program's place) fails the cell's limits, and the
program passes them.  ``python -m pytest bench/tests -m cuda`` on the
chip; skipped without a card."""
import pytest

import calibrate
from harness import manifest

CELLS = ("ds16b.train", "qwen2moe.decode", "ds16b.prefill")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(card, workload):
    m = manifest.load()
    limits = manifest.checks_of(manifest.cell(m, workload))
    r = calibrate.readings(m, workload, 2 ** 31 + 101, 2.0, "cuda", "int4")
    control = r["control"] if "control" in r else \
        {"malformed": 0.0, "logit_gap": r["control_logit_gap"]}
    assert all(r[k] <= v for k, v in limits.items()), r
    assert any(control[k] > v for k, v in limits.items()), r
